"""Golden-pair smoke test: the 4-stage cascade on one stereo pair, one
JET-colormapped PNG per stage.

Counterpart of the JAX package's `examples/golden_pair_inference.py`, the
manual regression check the reference documents (reference:
README.md:119-129, inference.py:66-70):

    python -m lwsnet_tpu_torch.tools.golden_pair_inference \
        --left L.png --right R.png [--ckpt results/finetune] \
        [--pdparams weights.pdparams] [--out results/golden_out] \
        [--device cuda]

The pair runs through `InferenceEngine.infer_files` (bottom-right crop to
368x1232, normalize, a warm-up forward, then the timed one: on the card,
the Hopper kernels). `--ckpt` reads a checkpoint directory of the port;
`--pdparams` the reference's released Paddle weights through
`convert.load_reference_checkpoint`, with which the stage PNGs should
reproduce the reference's 1-4.png. Without weights: the seed-0 random
network (shapes and finiteness only). Exits 1 if a stage is not finite.
The pair is named with `--left` / `--right`: the JAX tool's default, the
reference's golden pair, is not in the repository.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", type=str, default="")
    p.add_argument("--pdparams", type=str, default="",
                   help="reference .pdparams checkpoint to convert and load")
    p.add_argument("--out", type=str, default="results/golden_out")
    p.add_argument("--left", type=str, required=True)
    p.add_argument("--right", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from lwsnet_tpu_torch import LWSNet, ModelConfig
    from lwsnet_tpu_torch.device import resolve_device
    from lwsnet_tpu_torch.inference import (InferenceEngine,
                                            save_disparity_png)

    dev = resolve_device(args.device)
    cfg = ModelConfig()
    if args.pdparams:
        from lwsnet_tpu_torch.convert import load_reference_checkpoint
        state_dict = load_reference_checkpoint(args.pdparams)
    elif args.ckpt:
        from lwsnet_tpu_torch.tools.parity import load_weights
        state_dict = load_weights(args.ckpt)
    else:
        state_dict = LWSNet(cfg, device="cpu").state_dict()

    engine = InferenceEngine(cfg, state_dict, device=dev)
    disps, dt = engine.infer_files(args.left, args.right)
    print(f"4-stage inference: {dt * 1000:.1f} ms (the timed forward after "
          f"a warm-up{', CUDA events' if dev.type == 'cuda' else ''})")

    os.makedirs(args.out, exist_ok=True)
    stages = []
    for s, d in enumerate(disps):
        finite = bool(np.isfinite(d).all())
        print(f"stage {s + 1}: shape={d.shape} "
              f"range=[{d.min():.2f}, {d.max():.2f}] finite={finite}")
        save_disparity_png(os.path.join(args.out, f"{s + 1}.png"), d)
        stages.append({"stage": s + 1, "shape": list(d.shape),
                       "min": float(d.min()), "max": float(d.max()),
                       "finite": finite})
    print(f"wrote {len(disps)} stage PNGs to {args.out}")
    return {"seconds": dt, "stages": stages,
            "ok": all(st["finite"] for st in stages)}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
