"""Train, stat and eval steps of the port.

Counterpart of the JAX package's `training/steps.py` (reference loop body:
train.py:134-155). Every step runs the plain module path,
`LWSNet.forward(kernels=False)`: cuDNN convolutions and autograd. The
Hopper kernels are forward-only and stay off it, as the JAX train step
stays off Pallas. Steps update the `TrainState` in place and return it.

Under a process group (`parallel/mesh.py`) each process takes its slice of
the global batch, and the steps compute what the JAX steps compute under
pjit on the whole batch: batch norm reads global statistics, the loss is
divided by the global mask count, the gradients are summed over the
processes (one flat all-reduce: each process's loss is already its share
of the global one) before the norm, the clip and the finite test, so that
every process takes the same decision; aux reports the global loss, and
the eval sums and weights are summed over the processes.

Under row sharding each process takes its rows of its data slice's batch
(`Trainer` cuts them, `mesh.row_range`). The same reductions hold: the
halo exchanges carry the backward across the shard edges, batch norm sums
over unequal shards, and the mask count is the global one. The eval step
adds each example's EPE and D1 numerators and counts over the spatial
group before it divides.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from lwsnet_tpu_torch.config import TrainConfig
from lwsnet_tpu_torch.parallel import mesh
from lwsnet_tpu_torch.training import losses, metrics
from lwsnet_tpu_torch.training.state import (TrainState,
                                             clip_by_global_norm_,
                                             global_norm, make_lr_schedule)

BN_MODES = ("batch", "frozen")


def make_train_step(cfg: TrainConfig, steps_per_epoch: int) -> Callable:
    """Returns train_step(state, left, right, gt) -> (state, aux).

    aux = {"loss": scalar, "stage_losses": (num_stages,) before weighting,
           "lr": schedule(state.step) before the step, "grad_norm": the
           global gradient norm before the clip, "finite": 1.0 iff the loss
           and the gradient norm were finite}, tensors on the state's
    device ("lr" a float).

    `cfg.bn_mode` "batch" normalizes by the batch's statistics and updates
    the running ones; "frozen" runs the forward with batch norm in eval
    mode. With `cfg.skip_nonfinite_updates` a non-finite step changes no
    parameter, Adam moment or count, nor any running statistic; only
    `state.step` advances. The gradients the update used (after the clip)
    stay in each parameter's `.grad` until the next step.
    """
    if cfg.bn_mode not in BN_MODES:
        raise ValueError(f"bn_mode={cfg.bn_mode!r}: expected one of "
                         f"{BN_MODES}")
    schedule = make_lr_schedule(cfg, steps_per_epoch)

    def train_step(state: TrainState, left, right, gt
                   ) -> Tuple[TrainState, Dict]:
        model, opt = state.model, state.optimizer
        params = list(model.parameters())
        stats = list(model.buffers())
        saved = torch.cat([b.reshape(-1) for b in stats])
        model.train(cfg.bn_mode == "batch")
        opt.zero_grad(set_to_none=True)
        outputs = model(left, right)
        total, per_stage = losses.staged_loss(
            outputs, gt, cfg.loss_weights,
            min_disp=cfg.mask_min_disp, max_disp=cfg.mask_max_disp)
        total.backward()
        for p in params:  # a parameter off the graph has gradient 0
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        mesh.all_reduce_flat_(grads, "gradients")
        reported = mesh.all_reduce_(
            torch.cat([total.detach()[None], per_stage.detach()]), "loss")
        total, per_stage = reported[0], reported[1:]
        grad_norm = global_norm(grads)
        finite = bool(torch.isfinite(total) & torch.isfinite(grad_norm))
        if finite or not cfg.skip_nonfinite_updates:
            if cfg.grad_clip_norm > 0:
                clip_by_global_norm_(grads, cfg.grad_clip_norm,
                                     float(grad_norm))
            for group in opt.param_groups:
                group["lr"] = schedule(state.updates)
            opt.step()
            state.updates += 1
        else:
            with torch.no_grad():
                for b, old in zip(stats, saved.split(
                        [b.numel() for b in stats])):
                    b.copy_(old.view_as(b))
        aux = {"loss": total, "stage_losses": per_stage,
               "lr": schedule(state.step), "grad_norm": grad_norm,
               "finite": float(finite)}
        state.step += 1
        model.eval()
        return state, aux

    return train_step


def make_stat_step() -> Callable:
    """Returns stat_step(state, left, right) -> state with the running
    batch-norm statistics refreshed by one forward in batch-statistics
    mode, no parameter update: the building block of precise BN."""

    def stat_step(state: TrainState, left, right) -> TrainState:
        model = state.model
        model.train()
        with torch.no_grad():
            model(left, right)
        model.eval()
        return state

    return stat_step


def make_eval_step(max_disp: float = 192.0,
                   sceneflow_row_offset: int = 0) -> Callable:
    """Returns eval_step(state, left, right, gt, valid) ->
    {"epe": (stages,), "d1": (stages,), "weight": scalar}: per-stage EPE
    and D1 of each example, summed over the valid ones (padded eval rows
    carry valid 0) and over the processes; divide the sums by the summed
    weight. A non-zero `sceneflow_row_offset` drops that many top rows of
    each prediction (reference: train.py:189): `gt` has that many rows
    fewer than the images.

    Under row sharding the images are this process's rows and `gt` the
    rows its kept prediction rows cover (`Trainer.evaluate` cuts them):
    the shard holding the image's top rows drops those of the offset that
    fall in it, the prediction rows above `gt`."""

    def eval_step(state: TrainState, left, right, gt, valid
                  ) -> Dict[str, torch.Tensor]:
        model = state.model
        model.eval()
        with torch.no_grad():
            outputs = model(left, right)
        drop = outputs[0].shape[1] - gt.shape[1]
        if not (0 <= drop <= sceneflow_row_offset
                if mesh.spatial_count() > 1
                else drop == sceneflow_row_offset):
            raise ValueError(
                f"{outputs[0].shape[1]} prediction rows against "
                f"{gt.shape[1]} ground-truth rows with a row offset of "
                f"{sceneflow_row_offset}")
        terms = []  # (stages, B, 4): EPE and D1 numerators and counts
        for o in outputs:
            o = o[:, drop:, :, 0]
            terms.append(torch.stack([torch.cat([
                metrics.epe_terms(o[i], gt[i], max_disp),
                metrics.d1_terms(o[i], gt[i], max_disp)])
                for i in range(o.shape[0])]))
        terms = mesh.all_reduce_spatial_(torch.stack(terms), "eval_shards")
        e = metrics.epe_ratio(terms[..., :2])
        d = metrics.d1_ratio(terms[..., 2:])
        sums = torch.cat([(e * valid).sum(-1), (d * valid).sum(-1),
                          valid.sum()[None]])
        if mesh.spatial_index():  # the top shard reports each example
            sums.zero_()
        mesh.all_reduce_(sums, "eval")
        n = len(outputs)
        return {"epe": sums[:n], "d1": sums[n:2 * n], "weight": sums[-1]}

    return eval_step
