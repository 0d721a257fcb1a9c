"""Microbenchmark: three formulations of the cost filter's 3x3x3 conv.

Counterpart of the JAX package's `examples/microbench_3d.py`, on cuDNN
through `torch.nn.functional`. Per stage shape, one mid-layer conv
(Ci = Co = C, padding 1 in D, H and W) as

  a) conv3d   — `F.conv3d` over (B, C, D, H, W);
  b) folded   — D folded into channels: one 2D conv over (B, D*C, H, W)
                with the block-banded (D*Co, D*C, 3, 3) weight built from
                the (Co, C, 3, 3, 3) kernel;
  c) kdbatch  — D folded into batch: one 2D conv over (B*D, C, H, W) with
                the kd taps stacked as 3*Co outputs, then a shift-add
                along D.

It first checks that the three agree on a small shape (float32, TF32 off,
max |error| < 1e-3), then times each at the stage shapes in bf16 (CUDA
events, `utils.timing.device_time`), beside the card's name and power
limit:

    python -m lwsnet_tpu_torch.tools.microbench_3d

It needs a card and raises without one. Inputs are channels-first here;
the JAX tool's NDHWC tensors are the same values permuted.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

SMALL = (2, 4, 5, 8, 16)  # (B, C, D, H, W) of the equivalence check
EQUIV_BAR = 1e-3
SHAPES = [("stage1 mid", (1, 32, 24, 46, 154)),
          ("stage2 mid", (1, 8, 9, 92, 308)),
          ("stage3 mid", (1, 8, 9, 184, 616))]


def conv3d(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x (B, C, D, H, W), k (Co, C, 3, 3, 3)."""
    return F.conv3d(x, k, padding=1)


def banded_weight(k: torch.Tensor, D: int) -> torch.Tensor:
    """(Co, C, 3, 3, 3) -> (D*Co, D*C, 3, 3) with
    W2[do*Co + co, di*C + ci] = k[co, ci, di - do + 1] (zero elsewhere)."""
    Co, C = k.shape[:2]
    w2 = 0
    for kd in range(3):
        # band[di, do] = 1 where do = di + 1 - kd
        band = torch.diag(torch.ones(D - abs(1 - kd), dtype=k.dtype,
                                     device=k.device), 1 - kd)
        w2 = w2 + torch.einsum("pq,oihw->qopihw", band, k[:, :, kd])
    return w2.reshape(D * Co, D * C, 3, 3)


def folded(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    B, C, D, H, W = x.shape
    Co = k.shape[0]
    xf = x.transpose(1, 2).reshape(B, D * C, H, W)
    y = F.conv2d(xf, banded_weight(k, D), padding=1)
    return y.reshape(B, D, Co, H, W).transpose(1, 2)


def kdbatch(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    B, C, D, H, W = x.shape
    Co = k.shape[0]
    kc = torch.cat([k[:, :, 0], k[:, :, 1], k[:, :, 2]], 0)  # (3Co, C, 3, 3)
    y = F.conv2d(x.transpose(1, 2).reshape(B * D, C, H, W), kc, padding=1)
    y = y.reshape(B, D, 3, Co, H, W)
    yp = F.pad(y, (0, 0, 0, 0, 0, 0, 0, 0, 1, 1))  # pad D by one each side
    # out[d] = y0[d - 1] + y1[d] + y2[d + 1]
    out = yp[:, :D, 0] + yp[:, 1:D + 1, 1] + yp[:, 2:, 2]
    return out.transpose(1, 2)


IMPLS = {"conv3d": conv3d, "folded": folded, "kdbatch": kdbatch}


def check_equivalence(device) -> Dict[str, float]:
    """max |impl - conv3d| of each formulation at SMALL in float32 with
    TF32 off; raises past EQUIV_BAR."""
    from lwsnet_tpu_torch.tools.parity import tf32_off

    rng = np.random.default_rng(0)
    B, C, D, H, W = SMALL
    x = torch.as_tensor(rng.standard_normal(SMALL), dtype=torch.float32,
                        device=device)
    k = torch.as_tensor(rng.standard_normal((C, C, 3, 3, 3)),
                        dtype=torch.float32, device=device)
    errs = {}
    with tf32_off():
        ref = conv3d(x, k)
        for name, fn in IMPLS.items():
            errs[name] = float((fn(x, k) - ref).abs().max())
            if not errs[name] < EQUIV_BAR:
                raise AssertionError(f"{name}: max |err| {errs[name]:.3g}")
    return errs


def main(argv: Optional[List[str]] = None) -> Dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise RuntimeError("microbench_3d times cuDNN on the card; "
                           "torch.cuda.is_available() is False")
    from lwsnet_tpu_torch.utils.timing import card, device_time

    dev = torch.device("cuda")
    errs = check_equivalence(dev)
    for name, err in errs.items():
        print(f"{name}: max |err| = {err:.2e}")

    print(f"card: {card()}; bf16, batch 1")
    rng = np.random.default_rng(0)
    results: Dict[str, Dict[str, float]] = {}
    for label, shp in SHAPES:
        C = shp[1]
        x = torch.as_tensor(rng.standard_normal(shp),
                            dtype=torch.float32).to(dev, torch.bfloat16)
        k = torch.as_tensor(rng.standard_normal((C, C, 3, 3, 3)) * 0.1,
                            dtype=torch.float32).to(dev, torch.bfloat16)
        row = {name: device_time(lambda f=fn: f(x, k), iters=20) * 1e3
               for name, fn in IMPLS.items()}
        results[label] = row
        print("  ".join([label] + [f"{n}={ms:7.3f}ms" for n, ms in
                                   row.items()]))
    return {"equivalence_max_abs": errs, "ms": results}


if __name__ == "__main__":
    main()
