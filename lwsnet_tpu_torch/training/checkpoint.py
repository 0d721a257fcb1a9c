"""Best-only checkpoints with the reference's metadata.

Counterpart of the JAX package's `training/checkpoint.py`. The reference
saves the model, the optimizer and an {epoch, lr, error, time_cost} dict,
and only when the validation metric improves (reference: train.py:112-122,
finetune.py:127-137); resume restores all three (reference: train.py:82-105).

The port's format is its own: `<dir>/checkpoint`, a `torch.save` of
{"model": state dict (parameters and batch-norm statistics), "optimizer":
Adam's state dict, "step", "updates"}, and `<dir>/checkpoint.meta.json`.
Both are written to a temporary name and renamed into place. A JAX (Orbax)
checkpoint is read where JAX runs and bridged with
`lwsnet_tpu_torch.convert.from_jax_variables`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import torch

from lwsnet_tpu_torch.training.state import TrainState

_META_DEFAULTS = {"epoch": 0.0, "lr": 0.0, "error": 0.0, "time_cost": 0.0}


class CheckpointManager:
    """Best-only checkpoint manager mirroring the reference's policy."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)

    @property
    def path(self) -> str:
        return os.path.join(self.directory, "checkpoint")

    @property
    def meta_path(self) -> str:
        return self.path + ".meta.json"

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def save(self, state: TrainState, metadata: Dict[str, float]) -> None:
        """Save state + metadata, replacing the previous best."""
        os.makedirs(self.directory, exist_ok=True)
        payload = {"model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "step": state.step, "updates": state.updates}
        torch.save(payload, self.path + ".tmp")
        os.replace(self.path + ".tmp", self.path)
        with open(self.meta_path + ".tmp", "w") as f:
            json.dump({k: float(v) for k, v in metadata.items()}, f)
        os.replace(self.meta_path + ".tmp", self.meta_path)

    def _load(self, state: TrainState) -> dict:
        device = next(state.model.parameters()).device
        return torch.load(self.path, map_location=device, weights_only=True)

    def restore(self, state: TrainState
                ) -> Tuple[Optional[TrainState], Dict[str, float]]:
        """Load the checkpoint into `state` (model, optimizer, counters);
        (None, {}) if there is none."""
        if not self.exists():
            return None, {}
        payload = self._load(state)
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        state.updates = int(payload["updates"])
        metadata = dict(_META_DEFAULTS)
        if os.path.exists(self.meta_path):
            with open(self.meta_path) as f:
                metadata.update(json.load(f))
        return state, metadata

    def restore_params_only(self, state: TrainState
                            ) -> Optional[TrainState]:
        """Load the parameters and batch-norm statistics into `state`,
        keeping its optimizer and counters (the finetune bootstrap,
        reference: finetune.py:87-91); None if there is no checkpoint."""
        if not self.exists():
            return None
        state.model.load_state_dict(self._load(state)["model"], strict=True)
        return state
