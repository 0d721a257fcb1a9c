"""Microbenchmark: the stage-4 refinement's building blocks at 368x1232.

Counterpart of the JAX package's `examples/microbench_refine.py`, on
cuDNN through `torch.nn.functional` (NCHW, bf16): the 3x3 convs of the
towers and the head, the 1x1 pointwise conv, and each dilated depthwise
conv as a grouped conv against the explicit 9-tap shift-add, then the
dw-sep pair (shift-add d=8 + 1x1). Before timing it checks that the
shift-add computes the grouped conv (float32, TF32 off, max |delta| <
1e-4 at (1, 8, 64, 96) for d = 1, 2, 16; the JAX tool's 1e-1 was set for
the TPU's bf16 passes). Times are per call from CUDA events
(`utils.timing.device_time`), beside the card's name and power limit:

    python -m lwsnet_tpu_torch.tools.microbench_refine

It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

H, W = 368, 1232
EQUIV_SHAPE = (1, 8, 64, 96)  # (B, C, H, W) of the equivalence check
EQUIV_DILATIONS = (1, 2, 16)
EQUIV_BAR = 1e-4


def conv(x: torch.Tensor, k: torch.Tensor, dil: int = 1) -> torch.Tensor:
    """3x3 (or 1x1) conv, 'same' padding. x (B, Ci, H, W), k (Co, Ci, kh,
    kw)."""
    return F.conv2d(x, k, padding=dil * (k.shape[-1] // 2), dilation=dil)


def dwconv(x: torch.Tensor, k: torch.Tensor, dil: int = 1) -> torch.Tensor:
    """Depthwise 3x3 as a grouped conv. k (C, 1, 3, 3)."""
    return F.conv2d(x, k, padding=dil, dilation=dil, groups=x.shape[1])


def dw_shiftadd(x: torch.Tensor, k: torch.Tensor,
                dil: int = 1) -> torch.Tensor:
    """Depthwise 3x3 as nine shifted multiply-adds over a zero-padded
    input. k (C, 1, 3, 3)."""
    B, C, Hh, Ww = x.shape
    xp = F.pad(x, (dil, dil, dil, dil))
    out = None
    for dy in range(3):
        for dx in range(3):
            sl = xp[:, :, dy * dil:dy * dil + Hh, dx * dil:dx * dil + Ww]
            term = sl * k[:, 0, dy, dx].view(1, C, 1, 1)
            out = term if out is None else out + term
    return out


def check_equivalence(device) -> Dict[int, float]:
    """max |dw_shiftadd - dwconv| per dilation, float32 with TF32 off, at
    EQUIV_SHAPE; raises past EQUIV_BAR."""
    from lwsnet_tpu_torch.tools.parity import tf32_off

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(EQUIV_SHAPE), dtype=torch.float32,
                        device=device)
    k = torch.as_tensor(rng.standard_normal((EQUIV_SHAPE[1], 1, 3, 3)),
                        dtype=torch.float32, device=device)
    errs = {}
    with tf32_off():
        for d in EQUIV_DILATIONS:
            errs[d] = float((dwconv(x, k, d) - dw_shiftadd(x, k, d))
                            .abs().max())
            if not errs[d] < EQUIV_BAR:
                raise AssertionError(f"dw shift-add != dw conv at d={d}: "
                                     f"max |delta| {errs[d]:.3g}")
    return errs


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise RuntimeError("microbench_refine times cuDNN on the card; "
                           "torch.cuda.is_available() is False")
    from lwsnet_tpu_torch.utils.timing import card, device_time

    dev = torch.device("cuda")
    errs = check_equivalence(dev)
    print("dw shift-add == dw conv: ok (max |delta| "
          + ", ".join(f"d={d} {e:.2e}" for d, e in errs.items()) + ")")

    rng = np.random.default_rng(0)
    results: Dict[str, float] = {}

    def rnd(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float32).to(dev, torch.bfloat16)

    def t(label, fn, *args):
        results[label] = device_time(lambda: fn(*args), iters=20) * 1e3
        return results[label]

    x32, x64, x3 = rnd(1, 32, H, W), rnd(1, 64, H, W), rnd(1, 3, H, W)
    k33_3_32 = rnd(32, 3, 3, 3, scale=.1)
    k33_32_32 = rnd(32, 32, 3, 3, scale=.1)
    k33_64_32 = rnd(32, 64, 3, 3, scale=.1)
    kdw32 = rnd(32, 1, 3, 3, scale=.1)
    k11_32_32 = rnd(32, 32, 1, 1, scale=.1)

    print(f"card: {card()}; bf16 NCHW, batch 1, {H}x{W}")
    print(f"conv3x3 3->32:   {t('conv3x3 3->32', conv, x3, k33_3_32):7.3f} ms")
    print(f"conv3x3 32->32:  "
          f"{t('conv3x3 32->32', conv, x32, k33_32_32):7.3f} ms")
    print(f"conv3x3 64->32 d8: "
          f"{t('conv3x3 64->32 d8', conv, x64, k33_64_32, 8):7.3f} ms")
    print(f"conv1x1 32->32:  "
          f"{t('conv1x1 32->32', conv, x32, k11_32_32):7.3f} ms")
    for d in (2, 4, 8, 16):
        ms_c = t(f"dw3x3 d={d} conv", dwconv, x32, kdw32, d)
        ms_s = t(f"dw3x3 d={d} shiftadd", dw_shiftadd, x32, kdw32, d)
        print(f"dw3x3 d={d:2d}: conv={ms_c:7.3f} ms  shiftadd={ms_s:7.3f} ms")
    ms = t("dw(shiftadd,d8)+1x1",
           lambda a: conv(dw_shiftadd(a, kdw32, 8), k11_32_32), x32)
    print(f"dw(shiftadd,d8)+1x1: {ms:7.3f} ms")
    return {"equivalence_max_abs": {str(d): e for d, e in errs.items()},
            "ms": results}


if __name__ == "__main__":
    main()
