"""Anytime inference engine of the port: per-stage forwards + image IO.

Counterpart of the JAX package's `inference.py`. `make_forward` builds the
eval-mode forward, by default through the Hopper kernels
(`cfg.use_pallas`); `InferenceEngine` keeps one forward per
(input shape, stages), as the JAX engine keeps one compiled program.
Entry points run on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from lwsnet_tpu_torch.config import ModelConfig
from lwsnet_tpu_torch.data import png as stdpng
from lwsnet_tpu_torch.data import transforms as T
from lwsnet_tpu_torch.device import resolve_device
from lwsnet_tpu_torch.models.lwsnet import LWSNet
from lwsnet_tpu_torch.utils.colormap import colorize_disparity


def make_forward(model: LWSNet, num_stages: Optional[int] = None,
                 use_pallas: Optional[bool] = None,
                 device="cuda") -> Callable:
    """The inference forward of `model` on `device`.

    With `use_pallas` (default `model.cfg.use_pallas`) the stage cost
    filters (filter + skip + soft-argmin) and the stage-4 refinement run on
    the Hopper kernels; the rest (features, volumes, resizes) is plain
    PyTorch. Without it, the plain module path. Moves `model` to `device`.

    Returns forward(left, right) -> [disp_1 .. disp_stages], each
    (B, H, W, 1) float32, for NHWC normalized left/right on `device`.
    """
    dev = resolve_device(device)
    cfg = model.cfg
    stages = num_stages if num_stages is not None else cfg.num_stages
    if not 1 <= stages <= 4:
        raise ValueError(f"num_stages must be 1..4, got {stages}")
    kernels = cfg.use_pallas if use_pallas is None else use_pallas
    model.to(dev).eval()

    def forward(left: torch.Tensor, right: torch.Tensor
                ) -> List[torch.Tensor]:
        with torch.inference_mode():
            return model(left, right, num_stages=stages, kernels=kernels)

    return forward


class InferenceEngine:
    """An `LWSNet` with one forward per (input shape, stages)."""

    def __init__(self, cfg: ModelConfig, state_dict: Dict[str, torch.Tensor],
                 eval_height: int = 368, eval_width: int = 1232,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = LWSNet(cfg, device=self.device)
        self.model.load_state_dict(state_dict, strict=True)
        self.eval_height = eval_height
        self.eval_width = eval_width
        self._forwards: Dict[Tuple, Callable] = {}

    def _forward(self, shape: Tuple[int, ...], num_stages: int) -> Callable:
        key = (shape, num_stages)
        if key not in self._forwards:
            self._forwards[key] = make_forward(
                self.model, num_stages=num_stages, device=self.device)
        return self._forwards[key]

    def preprocess(self, left: np.ndarray, right: np.ndarray
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Bottom-right crop to the eval window + ImageNet normalize;
        (1, H, W, 3) float32 tensors on the engine's device."""
        th, tw = self.eval_height, self.eval_width
        out = []
        for img in (left, right):
            img = T.normalize(T.bottom_right_crop(img, th, tw))
            out.append(torch.from_numpy(
                np.ascontiguousarray(img[None], np.float32)).to(self.device))
        return out[0], out[1]

    def __call__(self, left: torch.Tensor, right: torch.Tensor,
                 num_stages: Optional[int] = None) -> List[np.ndarray]:
        """Run the cascade. left/right: (B, H, W, 3) normalized NHWC.
        Returns one (B, H, W) float32 array per stage."""
        stages = num_stages if num_stages is not None else self.cfg.num_stages
        outs = self._forward(tuple(left.shape), stages)(left, right)
        return [o[..., 0].cpu().numpy() for o in outs]

    def infer_files(self, left_path: str, right_path: str,
                    num_stages: Optional[int] = None
                    ) -> Tuple[List[np.ndarray], float]:
        """Load a pair from disk, run it, return (per-stage (H, W)
        disparities, seconds). The time covers the forward only, after one
        warm-up run, measured with CUDA events on the card."""
        l, r = self.preprocess(T.load_image(left_path),
                               T.load_image(right_path))
        stages = num_stages if num_stages is not None else self.cfg.num_stages
        fn = self._forward(tuple(l.shape), stages)
        fn(l, r)  # warm-up: kernel builds, cuDNN plans, allocator
        if self.device.type == "cuda":
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            outs = fn(l, r)
            end.record()
            end.synchronize()
            seconds = begin.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            outs = fn(l, r)
            seconds = time.perf_counter() - t0
        return [o[0, :, :, 0].cpu().numpy() for o in outs], seconds


def save_disparity_png(path: str, disp: np.ndarray,
                       colormap: bool = True) -> None:
    """Write a disparity map as a JET-colormapped PNG or raw 16-bit (KITTI
    submission format: uint16 = disp * 256)."""
    if colormap:
        stdpng.write_png(path, colorize_disparity(disp))
    else:
        stdpng.write_png(
            path, (np.clip(disp, 0, 255) * 256.0).astype(np.uint16))
