"""Epoch-level train/eval orchestration.

Counterpart of the JAX package's `training/loop.py` (reference loops:
train.py:107-199, finetune.py:122-210): per-epoch train pass, optional
precise-BN pass, validation, best-only checkpoints with {epoch, lr, error,
time_cost}, resume. Each numpy batch is pinned (on a card) and copied to
the device without blocking the host.

Under a process group (`parallel/mesh.py`) each process trains on its own
device (`cuda:LOCAL_RANK`) and reads its data slice of each epoch; the
steps reduce what the JAX steps reduce under pjit, so every process holds
the same state. `mesh_cfg` lays the group out as data x spatial, as the
JAX `Trainer(mesh_cfg=...)` does: the spatial partners of a data slice
read the same batches (and crops) and each takes its rows of every image
(`mesh.row_range`), cut on the host before the copy to the device.
Process 0 alone writes the checkpoint, and every process waits for it at
a barrier, so a later `resume` or `load_pretrained` reads a whole file on
each.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from lwsnet_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from lwsnet_tpu_torch.data.pipeline import StereoPipeline
from lwsnet_tpu_torch.models.blocks import BN_MOMENTUM, BatchNorm
from lwsnet_tpu_torch.parallel import mesh
from lwsnet_tpu_torch.training import steps as steps_lib
from lwsnet_tpu_torch.training.checkpoint import CheckpointManager
from lwsnet_tpu_torch.training.metrics import AverageMeter
from lwsnet_tpu_torch.training.state import TrainState, create_train_state


@dataclass
class TrainerConfig:
    model: ModelConfig
    train: TrainConfig
    eval_metric: str = "d1"  # "d1" (KITTI) or "epe" (SceneFlow)
    sceneflow_row_offset: int = 0  # 4 for SceneFlow eval (reference: train.py:189)


class Trainer:
    """Trains `tcfg.model` on `device` (default the card; raises without
    one unless `device="cpu"`; under a process group, this process's
    card). `history` holds one {epoch, step, loss, finite, lr, grad_norm}
    record per train step, with the global loss. `mesh_cfg` lays the
    process group out (`mesh.set_layout`; raises ValueError for a layout
    the world cannot hold). The pipelines must be this process's data
    slices (`mesh.data_index`, `mesh.data_count`)."""

    def __init__(self, tcfg: TrainerConfig, train_pipe: StereoPipeline,
                 eval_pipe: StereoPipeline, logger,
                 stat_pipe: Optional[StereoPipeline] = None,
                 device="cuda", mesh_cfg: MeshConfig = MeshConfig()):
        self.tcfg = tcfg
        mesh.set_layout(mesh_cfg)
        self.device = mesh.process_device(device)
        self.process_index = mesh.process_index()
        self.process_count = mesh.process_count()
        self.train_pipe = train_pipe
        self.eval_pipe = eval_pipe
        # Precise-BN batches; their size shapes the statistics (the JAX
        # Trainer documents the measured failure), so callers that change
        # the train batch between phases pass a fixed stat_pipe.
        self.stat_pipe = stat_pipe or train_pipe
        data = (mesh.data_index(), mesh.data_count())
        for pipe in (train_pipe, eval_pipe, self.stat_pipe):
            if (pipe.process_index, pipe.process_count) != data:
                raise ValueError(
                    f"pipeline slice {pipe.process_index}/"
                    f"{pipe.process_count} is not this process's data "
                    f"slice {data[0]}/{data[1]}")
        self.log = logger
        # Steps per epoch = this process's batch count: the epoch ->
        # step milestone conversion must not scale by the process count.
        spe = max(1, train_pipe.batches_per_epoch())
        self.steps_per_epoch = spe
        self.train_step = steps_lib.make_train_step(tcfg.train, spe)
        self.eval_step = steps_lib.make_eval_step(
            max_disp=tcfg.model.max_disp,
            sceneflow_row_offset=tcfg.sceneflow_row_offset)
        self.stat_step = steps_lib.make_stat_step()
        self.ckpt = CheckpointManager(tcfg.train.save_path)

        self.state: Optional[TrainState] = None
        self.best_error = math.inf
        self.start_epoch = 0
        self.start_time = time.time()
        self.last_lr = tcfg.train.lr  # live schedule value, from step aux
        self.last_error: Optional[float] = None  # of the last evaluate()
        self.history: List[Dict[str, float]] = []

    def _to_device(self, *arrays: np.ndarray, gt_offset: int = 0
                   ) -> List[torch.Tensor]:
        """The arrays on the device. Under row sharding each (B, H, ...)
        array is cut to this process's rows [r0, r1) of the first one's H;
        one of fewer rows (the SceneFlow eval ground truth, `gt_offset`
        rows short) to rows [max(r0, gt_offset), r1) less the offset."""
        h = arrays[0].shape[1]
        r0, r1 = mesh.row_range(h)
        out = []
        for a in arrays:
            if mesh.spatial_count() > 1 and a.ndim >= 3:
                a = a[:, r0:r1] if a.shape[1] == h else \
                    a[:, max(r0, gt_offset) - gt_offset:r1 - gt_offset]
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                t = t.pin_memory()
            out.append(t.to(self.device, non_blocking=True))
        return out

    # -- state management ---------------------------------------------------

    def init_state(self, seed: int = 0) -> TrainState:
        self.state = create_train_state(self.tcfg.model, self.tcfg.train,
                                        seed=seed, device=self.device)
        return self.state

    def resume(self) -> bool:
        """Restore the best checkpoint and its metadata
        (reference: train.py:82-105)."""
        if self.state is None:
            raise RuntimeError("call init_state() first")
        restored, meta = self.ckpt.restore(self.state)
        if restored is None:
            return False
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.best_error = float(meta.get("error", math.inf))
        self.start_time = time.time() - float(meta.get("time_cost", 0.0))
        self.log.info(
            "resumed: epoch=%d error=%.4f time_cost=%.2fh",
            self.start_epoch, self.best_error,
            float(meta.get("time_cost", 0.0)) / 3600)
        return True

    def load_pretrained(self, path: str) -> bool:
        """Bootstrap parameters and BN statistics from a pretrain
        checkpoint (reference: finetune.py:87-91)."""
        if self.state is None:
            raise RuntimeError("call init_state() first")
        if CheckpointManager(path).restore_params_only(self.state) is None:
            return False
        self.log.info("loaded pretrained params from %s", path)
        return True

    # -- epochs -------------------------------------------------------------

    def train_epoch(self, epoch: int) -> None:
        cfg = self.tcfg.train
        n_stages = self.tcfg.model.num_stages
        meters = [AverageMeter() for _ in range(n_stages)]
        n_batches = self.train_pipe.batches_per_epoch()

        for i, batch in enumerate(self.train_pipe.epoch(epoch)):
            left, right, gt = self._to_device(batch.left, batch.right,
                                              batch.disparity)
            self.state, aux = self.train_step(self.state, left, right, gt)
            # Meters average every batch (reference: train.py:149-152).
            stage_losses = aux["stage_losses"].cpu().numpy()
            for m, v in zip(meters, stage_losses):
                m.update(float(v))
            self.last_lr = float(aux["lr"])
            self.history.append(dict(
                epoch=epoch, step=self.state.step - 1,
                loss=float(aux["loss"]), finite=aux["finite"],
                lr=self.last_lr, grad_norm=float(aux["grad_norm"])))
            if i % cfg.log_every == 0:
                msg = "\t".join(
                    f"Stage {s} = {m.val:.2f}({m.avg:.2f})"
                    for s, m in enumerate(meters))
                self.log.info("Train Epoch%d [%d/%d]\t%s",
                              epoch, i, n_batches, msg)

        self.log.info(
            "Average train loss = %s",
            "\t".join(f"Stage {s} = {m.avg:.2f}" for s, m in enumerate(meters)))

    def _stat_batches(self, epoch: int, n: int):
        """`n` precise-BN batches on the device, from as many reshuffled
        epochs of the stat pipeline as it takes."""
        done = 0
        while done < n:
            for batch in self.stat_pipe.epoch(1_000_000 + epoch + done):
                yield self._to_device(batch.left, batch.right)
                done += 1
                if done >= n:
                    return

    def reestimate_bn(self, epoch: int) -> None:
        """Precise BN (cfg.bn_reestimate_batches > 0): refresh the running
        statistics with forward-only passes over training batches so that
        validation sees statistics that match the current parameters.
        Under a process group each stat step reads global statistics, so
        every process computes the same average.

        EWMA mode steps the running averages once a batch. Exact mode
        (cfg.bn_reestimate_exact) sets them to the moment average over the
        batches: from the unchanged statistics r0 each stat step gives
        r1 = m r0 + (1 - m) b, so b = (r1 - m r0) / (1 - m) with m the
        module's BN_MOMENTUM; a variance also takes the spread of its
        batch means. The result depends on the parameters only (the JAX
        Trainer's docstring has the measured failure this fixes)."""
        n = self.tcfg.train.bn_reestimate_batches
        if not n:
            return
        if not self.tcfg.train.bn_reestimate_exact:
            for left, right in self._stat_batches(epoch, n):
                self.state = self.stat_step(self.state, left, right)
            return

        bns = [m for m in self.state.model.modules()
               if isinstance(m, BatchNorm)]
        r0 = [(bn.running_mean.clone(), bn.running_var.clone())
              for bn in bns]
        m = BN_MOMENTUM
        sums = [[0.0, 0.0, 0.0] for _ in bns]  # mean, mean^2, var
        done = 0
        for left, right in self._stat_batches(epoch, n):
            self.state = self.stat_step(self.state, left, right)
            for acc, bn, (mean0, var0) in zip(sums, bns, r0):
                mean = (bn.running_mean - m * mean0) / (1.0 - m)
                var = (bn.running_var - m * var0) / (1.0 - m)
                acc[0] = acc[0] + mean
                acc[1] = acc[1] + mean * mean
                acc[2] = acc[2] + var
                bn.running_mean.copy_(mean0)
                bn.running_var.copy_(var0)
            done += 1
        with torch.no_grad():
            for acc, bn in zip(sums, bns):
                m1, m2 = acc[0] / done, acc[1] / done
                bn.running_mean.copy_(m1)
                bn.running_var.copy_(acc[2] / done + (m2 - m1 * m1))

    def evaluate(self) -> float:
        """One validation pass; returns the last stage's headline metric
        (D1 or EPE) and keeps it in `last_error`."""
        n_stages = self.tcfg.model.num_stages
        sums = np.zeros((2, n_stages))
        weight = 0.0
        for batch in self.eval_pipe.epoch(0):
            left, right, gt, valid = self._to_device(
                batch.left, batch.right, batch.disparity, batch.valid,
                gt_offset=self.tcfg.sceneflow_row_offset)
            out = self.eval_step(self.state, left, right, gt, valid)
            sums[0] += out["epe"].cpu().numpy()
            sums[1] += out["d1"].cpu().numpy()
            weight += float(out["weight"])
        weight = max(weight, 1.0)
        epes, d1s = sums[0] / weight, sums[1] / weight
        self.log.info("Average test EPE = %s",
                      ", ".join(f"Stage {s}={v:.2f}" for s, v in enumerate(epes)))
        self.log.info("Average test 3-Pixel Error = %s",
                      ", ".join(f"Stage {s}={v:.4f}" for s, v in enumerate(d1s)))
        self.last_error = float(d1s[-1] if self.tcfg.eval_metric == "d1"
                                else epes[-1])
        return self.last_error

    def fit(self, epochs: Optional[int] = None) -> float:
        if self.state is None:
            self.init_state(self.tcfg.train.seed)
        epochs = epochs if epochs is not None else self.tcfg.train.epochs
        error = self.best_error
        for epoch in range(self.start_epoch, epochs):
            self.train_epoch(epoch)
            self.reestimate_bn(epoch)
            error = self.evaluate()
            # `error` is the same on every process (the eval sums are
            # reduced), so all take this branch together.
            if error < self.best_error:
                self.best_error = error
                if self.process_index == 0:
                    self.ckpt.save(
                        self.state,
                        {"epoch": epoch, "lr": self.last_lr, "error": error,
                         "time_cost": time.time() - self.start_time})
                mesh.barrier()
                self.log.info("save model param success")
        self.log.info("full training time = %.2f Hours",
                      (time.time() - self.start_time) / 3600)
        return error
