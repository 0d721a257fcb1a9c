"""Configuration of the PyTorch port.

Field for field the same dataclasses as the JAX package's `config.py`, with
the same defaults and the same published recipes (`pretrain_config`,
`finetune_config`). What reads differently here: `ModelConfig.dtype`
gives a `torch.dtype`; `ModelConfig.use_pallas` selects the hand-written
Hopper kernels (`lwsnet_tpu_torch.ops.cuda`) for the inference path, while
training always runs the plain module path (`LWSNet.forward`); the loss
mask's open bounds are Python floats.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# "float64" runs the module path as a reference (chip_smoke.py phase 4);
# the kernels take float32 and bfloat16.
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}
PALLAS_MODES = ("rows", "layers")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (reference: train.py:21-29)."""

    max_disp: int = 192
    # Stage 1 searches [0, 24) at 1/8 res; stages 2-3 search residual
    # offsets in [-4, 4] at 1/4 and 1/2 res.
    max_disp_list: Tuple[int, ...] = (24, 5, 5)
    channels_3d: int = 8
    layers_3d: int = 4
    growth_rate: Tuple[int, ...] = (4, 1, 1)
    refine_channels: int = 32
    feature_channels: int = 8
    # Compute dtype of convolutions and cost volumes. Parameters and
    # batch-norm statistics always stay float32.
    compute_dtype: str = "bfloat16"
    # True: the inference forward runs the cost filters and the refinement
    # through the Hopper kernels. False: the plain module path.
    use_pallas: bool = True
    # Stage-4 refinement path: "rows" (the two towers as one 2B batch, an
    # engine picked by `rows_dw`) or "layers" (each tower on its own,
    # dw-sep layers paired as the JAX planar path pairs them; `rows_dw` and
    # `rows_paired` are ignored). Any other value raises ValueError.
    pallas_mode: str = "rows"
    # With rows_dw="vpu": two dw-sep layers per dwsep3x3 launch (True) or
    # one (False). Ignored by "mxu" and "chain".
    rows_paired: bool = True
    # "rows" refinement engine: "mxu" (every dw-sep layer as one dense3x3
    # over the composed rank-1 kernel), "vpu" (dw-sep layers on dwsep3x3)
    # or "chain" (each tower stack and the head as one chain3x3 launch).
    rows_dw: str = "mxu"
    # All conv3d formulations of the JAX package compute the same function;
    # the port has one.
    conv3d_impl: str = "auto"
    num_stages: int = 4

    def __post_init__(self):
        if self.pallas_mode not in PALLAS_MODES:
            raise ValueError(f'pallas_mode="{self.pallas_mode}": expected '
                             f'one of {PALLAS_MODES}')

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline settings (reference: dataloader/dataloader.py:61-92)."""

    datapath: str = ""
    val_split_file: str = ""  # KITTI val split; empty -> builtin 40 frames
    crop_height: int = 256
    crop_width: int = 512
    eval_height: int = 368  # KITTI eval window
    eval_width: int = 1232
    sceneflow_eval_height: int = 544
    sceneflow_eval_width: int = 960
    num_workers: int = 8
    prefetch_depth: int = 2
    shuffle_seed: int = 0
    # The reference indexes SceneFlow's 15mm driving split twice and never
    # the 35mm one; True reproduces that corpus.
    sceneflow_compat_duplicate_15mm: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization settings (reference: train.py:30-34, finetune.py:29-33);
    the JAX package's `TrainConfig` documents each choice."""

    lr: float = 5e-4
    epochs: int = 10
    train_batch_size: int = 8
    eval_batch_size: int = 8
    loss_weights: Tuple[float, ...] = (0.25, 0.5, 1.0, 1.0)
    # MultiStep decay of the KITTI recipe, in epochs.
    lr_milestones: Tuple[int, ...] = ()
    lr_gamma: float = 0.1
    # Linear warmup 0 -> lr over this many optimizer updates (0 = off).
    warmup_steps: int = 0
    # Precise BN (`Trainer.reestimate_bn`): EWMA stat steps (False) or the
    # exact moment average over the batches (True).
    bn_reestimate_exact: bool = False
    # Loss mask, exclusive bounds: pretrain gt < max_disp, finetune gt > 0.
    mask_min_disp: float = float("-inf")
    mask_max_disp: float = float("inf")
    # Clip gradients to this global norm; 0 disables.
    grad_clip_norm: float = 5.0
    # A step whose loss or gradient norm is not finite changes no parameter,
    # optimizer moment or batch-norm statistic.
    skip_nonfinite_updates: bool = True
    # "batch": normalize by the batch's statistics and update the running
    # ones; "frozen": normalize by the running statistics, which stay.
    bn_mode: str = "batch"
    # Forward-only passes over training batches that refresh the BN
    # running statistics before each validation (0 = off).
    bn_reestimate_batches: int = 0
    save_path: str = "results/run"
    resume: str = ""
    pretrained: str = ""
    log_every: int = 5
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout of the JAX package's data / spatial sharding.
    The port lays the processes of a `torch.distributed` group, one device
    each, out as `data_parallel` x `spatial_parallel` (`parallel/mesh.py`;
    rank = d * spatial_parallel + s): the batch is split over the data
    slices and each image's rows over the `spatial_parallel` processes of
    a slice, with halo exchanges at the shard edges. `data_parallel` -1
    takes the world / spatial_parallel; a layout the world cannot hold
    raises ValueError."""

    data_axis: str = "data"
    spatial_axis: str = "spatial"
    data_parallel: int = -1  # -1 => all devices
    spatial_parallel: int = 1


def pretrain_config(datapath: str = "dataset/sceneflow/") -> tuple:
    """The published SceneFlow recipe (reference: train.py:19-39)."""
    model = ModelConfig()
    data = DataConfig(datapath=datapath)
    train = TrainConfig(
        lr=5e-4, epochs=10, train_batch_size=8, eval_batch_size=8,
        mask_max_disp=192.0, save_path="results/pretrained",
    )
    return model, data, train


def finetune_config(datapath: str = "dataset/kitti2015/training/") -> tuple:
    """The published KITTI2015 recipe (reference: finetune.py:18-41)."""
    model = ModelConfig()
    data = DataConfig(datapath=datapath)
    train = TrainConfig(
        lr=5e-4, epochs=300, train_batch_size=4, eval_batch_size=8,
        lr_milestones=(200, 400), lr_gamma=0.1,
        mask_min_disp=0.0, save_path="results/finetune",
    )
    return model, data, train
