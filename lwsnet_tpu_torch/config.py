"""Model configuration of the PyTorch port.

Field for field the same as the JAX package's `ModelConfig`, with the same
defaults. Two fields read differently here: `dtype` gives a `torch.dtype`,
and `use_pallas` selects the hand-written Hopper kernels
(`lwsnet_tpu_torch.ops.cuda`) for the inference path; the module path
(`LWSNet.forward`) is the plain PyTorch counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
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
