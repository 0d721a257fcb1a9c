"""Each kernel family against the module path where parity is well-posed.

Counterpart of the JAX package's `examples/parity_kernels_tpu.py`. The
whole-path check (`tools.parity`) compares the cascade, whose cascaded
soft-argmin amplifies rounding near tied cost bins into pixels at a
not-yet-converged state; this tool pins the kernels where that cannot
happen, in bfloat16 and float32 (TF32 off), on the model's weights:

* the stage-4 refinement residual, a plain CNN (no argmin), on the left
  image and a smooth disparity field: `refine_residual` (the Hopper
  kernels of the config's engine) against the towers + head modules;
* each stage's cost filter + skip + soft-argmin on sharply peaked
  synthetic cost volumes (an unambiguous argmin):
  `costfilter.filter_soft_argmin` against `CostFilter3D` + `soft_argmin`.

PASS: every check's mean |delta| < 0.1 % (float32) / 2 % (bf16) of the
module path's span, the kernel output finite. The JAX tool's JSON:

    python -m lwsnet_tpu_torch.tools.parity_kernels [--ckpt DIR|FILE:SET] \
        [--dtypes bfloat16 float32] [--left_img PNG] \
        [--out results/PARITY_KERNELS.json] [--device cuda]

The left image defaults to `tools.parity.fixture_pair(0)`'s (the JAX
tool's golden image is not in the repository); `--ckpt` as in
`tools.parity`. Runs on the card (raises without one) unless
`--device cpu`. The left image is cropped bottom-right to H x W.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

H, W = 368, 1232


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=str,
                   default="results/PARITY_KERNELS.json")
    p.add_argument("--ckpt", type=str, default="",
                   help="a checkpoint directory of the port, or FILE:SET")
    p.add_argument("--dtypes", nargs="*", default=["bfloat16", "float32"])
    p.add_argument("--left_img", type=str, default="")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.data import transforms as T
    from lwsnet_tpu_torch.device import resolve_device
    from lwsnet_tpu_torch.models.refine_kernels import refine_residual
    from lwsnet_tpu_torch.ops import stereo
    from lwsnet_tpu_torch.ops.cuda.costfilter import filter_soft_argmin
    from lwsnet_tpu_torch.tools.parity import (build_model, delta_stats,
                                               fixture_pair, load_weights,
                                               tf32_off)

    dev = resolve_device(args.device)
    base = ModelConfig()
    state_dict = load_weights(args.ckpt)
    left = (T.normalize(T.load_image(args.left_img)) if args.left_img
            else fixture_pair(0)[0])
    left = torch.as_tensor(np.ascontiguousarray(
        T.bottom_right_crop(left, H, W)[None], np.float32), device=dev)
    rng = np.random.default_rng(0)
    ys = np.linspace(0, 3, H, dtype=np.float32)[:, None]
    xs = np.linspace(0, 5, W, dtype=np.float32)[None, :]
    disp = torch.as_tensor(
        (30 + 12 * np.sin(ys) + 9 * np.cos(xs))[None, :, :, None],
        device=dev)

    checks: List[Dict] = []

    def record(name, dt_name, a, b, bar):
        st = delta_stats(a.cpu().numpy(), b.cpu().numpy())
        ok = bool(np.isfinite(b.cpu().numpy()).all()
                  and st["mean_abs_delta"] < bar * st["span"])
        checks.append({
            "check": name, "dtype": dt_name,
            "span": round(st["span"], 4),
            "mean_abs_delta": round(st["mean_abs_delta"], 6),
            "max_abs_delta": round(st["max_abs_delta"], 5),
            "mean_delta_pct_of_span": round(st["mean_delta_pct_of_span"], 4),
            "bar_pct": bar * 100, "ok": ok})

    # Full float32 (the counterpart of JAX's "highest"); bf16 convs are
    # not affected.
    with tf32_off(), torch.inference_mode():
        for dt_name in args.dtypes:
            bar = 0.001 if dt_name == "float32" else 0.02
            model = build_model(ModelConfig(compute_dtype=dt_name),
                                state_dict, dev)
            dt = model.cfg.dtype

            # 1. The stage-4 residual: a plain CNN, parity holds for any
            #    weights (reference: models/submodules.py:282-326).
            tl = model.RefinementTower_0(left.permute(0, 3, 1, 2).to(dt))
            td = model.RefinementTower_1(disp.permute(0, 3, 1, 2).to(dt))
            a = model.RefinementHead_0(torch.cat([tl, td], 1)).permute(
                0, 2, 3, 1).float()
            b = refine_residual(model, left, disp, dtype=dt)
            record("refinement_residual", dt_name, a, b, bar)

            # 2. Cost filter + skip + soft-argmin per stage on sharply
            #    peaked volumes (reference: models/models.py:136-156).
            for scale in range(3):
                div = (8, 4, 2)[scale]
                fh, fw = H // div, W // div
                D = base.max_disp_list[scale]
                Dn = D if scale == 0 else 2 * D - 1
                start = 0 if scale == 0 else -D + 1
                d0 = (Dn - 1) * rng.random((1, fh, fw, 1)).astype(np.float32)
                bins = np.arange(Dn, dtype=np.float32)
                # A cost (low = best): the peak of softmax(-cost) is at d0.
                cost = torch.as_tensor(
                    np.abs(bins - d0) * 3.0
                    + 0.1 * rng.random((1, fh, fw, Dn)).astype(np.float32),
                    device=dev)
                filt = getattr(model, f"CostFilter3D_{scale}")
                a = stereo.soft_argmin(filt(cost) + cost, start, start + Dn)
                b = filter_soft_argmin(
                    cost, dict(filt.named_parameters()),
                    dict(filt.named_buffers()), layers=base.layers_3d,
                    channels=base.channels_3d * base.growth_rate[scale],
                    start=start, dtype=dt)
                record(f"costfilter_stage{scale + 1}", dt_name, a, b, bar)
            del model

    ok_all = all(c["ok"] for c in checks)
    result = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "weights": args.ckpt or "random-init (seed 0)",
        "pallas_mode": base.pallas_mode,
        "rows_dw": base.rows_dw,
        "bars": "mean |delta| < 0.1% (f32) / 2% (bf16) of the module "
                "path's span",
        "checks": checks,
        "pass": ok_all,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1, allow_nan=False)
    print(json.dumps(result, allow_nan=False))
    return result


if __name__ == "__main__":
    raise SystemExit(0 if main()["pass"] else 1)
