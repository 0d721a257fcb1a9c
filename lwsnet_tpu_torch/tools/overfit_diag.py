"""Overfit-dynamics microscope: short training runs with per-step telemetry.

Counterpart of the JAX package's `examples/overfit_diag.py`, with its
configurations, options and result JSON. It trains the port on a fixed
set of synthetic stereo pairs with exactly known ground truth (the same
generator as `tools.overfit_proof`), one configuration after another, and
records per-step telemetry (total and per-stage loss, gradient norm, lr),
then the final stage-4 loss and EPE in both batch-norm modes (train mode:
the batch statistics the loss saw; eval mode: the running statistics a
checkpoint's eval sees), the eval-mode EPE after re-estimating the running
statistics at the final parameters ("restat", 4 x nb stat steps), and the
loss of one more train step from the final state, which must agree with
the train-mode loss. The JAX tool ran the steps inside chunked
`lax.scan`s to spare a TPU transport long dispatches; here a host loop
calls `training.steps.make_train_step` once a step.

    python -m lwsnet_tpu_torch.tools.overfit_diag --source PNG \
        [--steps 800] [--configs baseline f32 const_lr] [--device cuda]

`--source` names the image the strips are cut from, any RGB PNG of at
least 256x560 (the JAX tool reads the reference's golden left image,
which is not in the repository). Runs on the card (raises without one)
unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from lwsnet_tpu_torch.tools.overfit_proof import MARGIN, synth_pair

H, W = 256, 512


def build_batches(src: np.ndarray, n_pairs: int, batch: int, seed: int = 0,
                  amp: float = 3.0
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`n_pairs` synthetic pairs from random (H, W + MARGIN) strips of
    `src` (float RGB in [0, 1]), drawn as the JAX tool draws them,
    normalized and stacked into (nb, batch, H, W, ...) arrays."""
    from lwsnet_tpu_torch.data import transforms as T

    h, w = H, W
    rng = np.random.default_rng(seed)
    lefts, rights, disps = [], [], []
    for _ in range(n_pairs):
        y0 = int(rng.integers(0, src.shape[0] - h + 1))
        x0 = int(rng.integers(0, src.shape[1] - w - MARGIN + 1))
        strip = src[y0:y0 + h, x0:x0 + w + MARGIN]
        left, right, disp = synth_pair(strip, rng, amp=amp)
        lefts.append(T.normalize(left))
        rights.append(T.normalize(right))
        disps.append(disp)
    nb = n_pairs // batch
    return (np.stack(lefts).reshape(nb, batch, h, w, 3),
            np.stack(rights).reshape(nb, batch, h, w, 3),
            np.stack(disps).reshape(nb, batch, h, w))


CONFIGS = {
    # the committed OVERFIT_PROOF configuration
    "baseline": dict(dtype="bfloat16", lr=1e-3, milestones=(250, 450, 650)),
    # is bf16 compute the loss floor?
    "f32": dict(dtype="float32", lr=1e-3, milestones=(250, 450, 650)),
    # is the epoch-250 decay freezing progress?
    "const_lr": dict(dtype="bfloat16", lr=1e-3, milestones=()),
    "const_lr_f32": dict(dtype="float32", lr=1e-3, milestones=()),
    # tighter grad clip against the gnorm-explosion instability
    "clip1": dict(dtype="bfloat16", lr=1e-3, milestones=(250, 450, 650),
                  clip=1.0),
    # decay before the ~step-150 instability onset, shallower (0.3)
    "early_decay": dict(dtype="bfloat16", lr=1e-3, gamma=0.3,
                        milestones=(120, 280, 450, 620)),
    "early_decay_f32": dict(dtype="float32", lr=1e-3, gamma=0.3,
                            milestones=(120, 280, 450, 620)),
    # frozen-BN training: removes the batch-stat co-adaptation that makes
    # tiny-fixed-set training chaotically sharp (see TrainConfig.bn_mode)
    "frozen": dict(dtype="bfloat16", lr=1e-3, milestones=(250, 450, 650),
                   bn="frozen"),
    "frozen_const": dict(dtype="bfloat16", lr=1e-3, milestones=(),
                         bn="frozen"),
    # prime running stats with forward passes BEFORE freezing: frozen-at-
    # init stats leave activations unnormalized -> saturated soft-argmin ->
    # stages 1-2 get no gradient (observed: stage-1 loss pinned at its init
    # value for 800 steps)
    "primed": dict(dtype="bfloat16", lr=1e-3, milestones=(250, 450, 650),
                   bn="frozen", prime=60),
    "primed_const": dict(dtype="bfloat16", lr=1e-3, milestones=(),
                         bn="frozen", prime=60),
    # the reference's own finetune hyperparameters (lr 5e-4, one 0.1 decay
    # at 2/3 of the run; reference finetune.py:82-84), for use with a
    # diverse (>=64-pair) synthetic set where batch statistics stay healthy
    "ref_sched": dict(dtype="bfloat16", lr=5e-4, milestones=(530,)),
    "ref_sched_2k": dict(dtype="bfloat16", lr=5e-4, milestones=(1300,)),
}


def run_config(name: str, spec: Dict, batches, steps: int, out: List,
               device="cuda") -> Dict:
    """Train configuration `spec` for `steps` steps over `batches` (step i
    takes batch i % nb) from the seed-0 initial weights; append the result
    dict to `out` and return it."""
    import torch

    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.device import resolve_device
    from lwsnet_tpu_torch.training import losses as L
    from lwsnet_tpu_torch.training import metrics as M
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.training.steps import (make_stat_step,
                                                 make_train_step)

    dev = resolve_device(device)
    l, r, g = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
               for a in batches)
    nb = l.shape[0]
    tcfg = TrainConfig(lr=spec["lr"], train_batch_size=l.shape[1],
                       mask_min_disp=0.0,
                       lr_milestones=tuple(spec["milestones"]),
                       lr_gamma=spec.get("gamma", 0.1),
                       grad_clip_norm=spec.get("clip", 5.0),
                       bn_mode=spec.get("bn", "batch"))
    # milestones are epochs; with nb batches an epoch the schedule
    # converts them to steps as the Trainer does
    state = create_train_state(ModelConfig(compute_dtype=spec["dtype"]),
                               tcfg, seed=0, device=dev)
    model = state.model
    step = make_train_step(tcfg, nb)
    stat_step = make_stat_step()

    # prime the running statistics with forwards before a frozen run
    for i in range(spec.get("prime", 0)):
        state = stat_step(state, l[i % nb], r[i % nb])

    t0 = time.time()
    tel: Dict[str, List] = {"loss": [], "stage": [], "gnorm": [], "lr": []}
    for i in range(steps):
        b = i % nb
        state, aux = step(state, l[b], r[b], g[b])
        tel["loss"].append(float(aux["loss"]))
        tel["stage"].append(aux["stage_losses"].tolist())
        tel["gnorm"].append(float(aux["grad_norm"]))
        tel["lr"].append(float(aux["lr"]))
    wall = time.time() - t0
    loss = np.asarray(tel["loss"])

    def buffers():
        return [b.clone() for b in model.buffers()]

    def restore(saved):
        with torch.no_grad():
            for b, s in zip(model.buffers(), saved):
                b.copy_(s)

    def dbg(lb, rb, gb) -> Dict[str, float]:
        """Stage-4 loss and EPE with train-mode batch norm (the batch
        statistics the loss saw) and eval-mode (the running ones a
        checkpoint's eval sees), the running statistics left as found."""
        res = {}
        saved = buffers()
        for tag, train in (("train", True), ("eval", False)):
            model.train(train)
            with torch.no_grad():
                outs = model(lb, rb)
            restore(saved)
            _, per = L.staged_loss(outs, gb, tcfg.loss_weights,
                                   min_disp=0.0)
            res[f"loss4_{tag}"] = float(per[-1])
            res[f"epe_{tag}"] = float(M.epe(outs[-1][..., 0], gb, 192.0))
        model.eval()
        return res

    def mean_dbg(key):
        return round(float(np.mean([dbg(l[b], r[b], g[b])[key]
                                    for b in range(nb)])), 4)

    d0 = {k: mean_dbg(k)
          for k in ("loss4_train", "loss4_eval", "epe_train", "epe_eval")}

    # Precise BN after training: re-estimate the running statistics at the
    # final parameters, then re-evaluate; the final state keeps its own.
    final = buffers()
    for i in range(4 * nb):
        state = stat_step(state, l[i % nb], r[i % nb])
    d0["epe_eval_restat"] = mean_dbg("epe_eval")
    restore(final)
    # The same train step once more from the final state: its loss must
    # agree with dbg's train-mode loss on batch 0.
    _, aux_chk = step(state, l[0], r[0], g[0])

    res = {
        "config": name, **{k: (list(v) if isinstance(v, tuple) else v)
                           for k, v in spec.items()},
        "steps": steps,
        "wall_s": round(wall, 1),
        "first_loss": round(float(loss[0]), 3),
        "last_loss": round(float(loss[-1]), 4),
        "min_loss": round(float(loss.min()), 4),
        "argmin_loss": int(loss.argmin()),
        "final_epe_eval": d0["epe_eval"],
        "final_epe_train": d0["epe_train"],
        "final_loss4_eval": d0["loss4_eval"],
        "final_loss4_train": d0["loss4_train"],
        "step_loss_recheck": round(float(aux_chk["loss"]), 4),
        "step_stage_recheck": [round(float(v), 4)
                               for v in aux_chk["stage_losses"]],
        "epe_eval_restat": d0["epe_eval_restat"],
        "loss_last_10": [round(float(x), 3) for x in loss[-10:]],
        "max_gnorm": round(float(max(tel["gnorm"])), 2),
        "final_stage_losses": [round(float(x), 4) for x in tel["stage"][-1]],
        "loss_every_25": [round(float(x), 3) for x in loss[::25]],
        "gnorm_every_25": [round(float(x), 2) for x in tel["gnorm"][::25]],
    }
    print(json.dumps(res))
    out.append(res)
    return res


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--pairs", type=int, default=4)
    p.add_argument("--amp", type=float, default=3.0)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--configs", nargs="*", default=list(CONFIGS))
    p.add_argument("--out", default="results/overfit_diag.json")
    p.add_argument("--source", type=str, required=True,
                   help="RGB PNG the strips are cut from")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from lwsnet_tpu_torch.data import transforms as T

    batches = build_batches(T.load_image(args.source), args.pairs,
                            args.batch, amp=args.amp)
    out: List[Dict] = []
    for name in args.configs:
        run_config(name, CONFIGS[name], batches, args.steps, out,
                   device=args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
