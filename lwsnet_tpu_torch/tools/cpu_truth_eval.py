"""Float32 ground-truth evaluation of a checkpoint on the proof corpus.

Counterpart of the JAX package's `examples/cpu_truth_eval.py`, the neutral
arbiter of `tools.overfit_proof`: the stage-4 EPE of a checkpoint of the
port over the overfit workdir's pairs (l_i.png, r_i.png, d_i.png), one
pair at a time (no batching), through the plain module path in float32,
with the JAX tool's JSON. Its purpose is to run on the CPU, away from the
card's programs and their rounding; it has no default device, so the
caller names it: `--device cpu` for the arbiter, `--device cuda` for the
same on the card with TF32 off.

    python -m lwsnet_tpu_torch.tools.cpu_truth_eval --ckpt DIR \
        --device cpu [--workdir results/overfit_proof] [--pairs 64] \
        [--out PATH]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np
import torch


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--workdir", default="results/overfit_proof")
    ap.add_argument("--pairs", type=int, default=64)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", required=True,
                    help="cpu (the arbiter) or cuda")
    args = ap.parse_args(argv)

    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.data import transforms as T
    from lwsnet_tpu_torch.data.png import read_png
    from lwsnet_tpu_torch.tools.parity import tf32_off
    from lwsnet_tpu_torch.training import metrics
    from lwsnet_tpu_torch.training.checkpoint import CheckpointManager
    from lwsnet_tpu_torch.training.state import create_train_state

    state = create_train_state(ModelConfig(compute_dtype="float32"),
                               TrainConfig(), seed=0, device=args.device)
    restored, meta = CheckpointManager(args.ckpt).restore(state)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint in {args.ckpt}")
    model = restored.model.eval()
    dev = next(model.parameters()).device

    def load(path):
        return torch.as_tensor(T.normalize(T.load_image(path))[None],
                               device=dev)

    epes = []
    with tf32_off(), torch.inference_mode():
        for i in range(args.pairs):
            left = load(f"{args.workdir}/l_{i}.png")
            right = load(f"{args.workdir}/r_{i}.png")
            d = torch.as_tensor(
                read_png(f"{args.workdir}/d_{i}.png").astype(np.float32)
                / 256.0, device=dev)[None]
            out = model(left, right, kernels=False)[-1]
            epes.append(float(metrics.epe(out[..., 0], d, 192.0)))
    result = {"ckpt": args.ckpt,
              "ckpt_meta": {k: float(v) for k, v in meta.items()},
              "pairs": args.pairs,
              "device": str(dev),
              "cpu_f32_stage4_epe_px": round(float(np.mean(epes)), 3),
              "per_pair_max": round(float(np.max(epes)), 3)}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
