"""Microbenchmark: the stage-4 refinement kernels at the 368x1232 eval shape.

Counterpart of the JAX package's `examples/microbench_rows.py`, on the card
only (it raises without one; there is no CPU mode):

    python -m lwsnet_tpu_torch.tools.microbench_rows [--json PATH] [--full]

It prints the JAX tool's `label: x ms` lines where the port has a
counterpart, on the port's NCHW layers in bf16: the dw-sep layer by
dilation, at batch 2, as one dense conv over the composed kernel ("mxu"),
the three dense shapes, the head entry as concat + dense against the
two-input conv, the paired against the unpaired tower pairs, and the whole
`refine_residual` under each engine and under `pallas_mode="layers"`. A
line that measured a TPU layout device (the row canvas, the pre-broadcast
operands) times the port's permute that stands in its place, or prints
`n/a` with the reason. The probe line launches `lane_broadcast` and prints
`OK` only if it equals its plain version; a wrong result raises. Times are
per call, from CUDA events (`utils.timing.device_time`), beside the card's
name and power limit. `main` returns what `--json` writes: the card, the
probe's verdict and {label: ms}.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np
import torch

H, W = 368, 1232
C = 32


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", type=str, default="",
                    help="also dump every measurement to this JSON file")
    ap.add_argument("--full", action="store_true",
                    help="also time the (8, 16) tower pair against its two "
                         "solo layers")
    cli = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("microbench_rows times the CUDA kernels and needs "
                           "a card; torch.cuda.is_available() is False")

    from lwsnet_tpu_torch import LWSNet, ModelConfig
    from lwsnet_tpu_torch.models.refine_kernels import refine_residual
    from lwsnet_tpu_torch.ops.cuda import refine_rows as R
    from lwsnet_tpu_torch.ops.cuda.probe import (lane_broadcast,
                                                 lane_broadcast_plain)
    from lwsnet_tpu_torch.utils.timing import card, device_time

    results: Dict[str, float] = {}

    def say(label: str, ms: Optional[float] = None, note: str = "") -> None:
        if ms is None:
            print(f"{label}: {note}", flush=True)
            return
        results[label] = ms
        print(f"{label}: {ms:7.3f} ms", flush=True)

    def t(fn, iters: int = 50) -> float:
        return device_time(fn, iters=iters) * 1e3

    smi = card()
    print(f"card: {smi}; layout: NCHW planes (B, {C}, {H}, {W}) bf16, no "
          f"canvas", flush=True)
    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = np.random.default_rng(0)

    def rnd(*shape, scale=1.0, dtype=dt):
        return torch.as_tensor(gen.standard_normal(shape) * scale,
                               dtype=torch.float32).to(dev, dtype)

    def affine(c):
        return torch.as_tensor(np.stack([gen.uniform(0.5, 1.5, c),
                                         gen.normal(0, 0.5, c)]),
                               dtype=torch.float32, device=dev)

    x, x2 = rnd(1, C, H, W), rnd(2, C, H, W)
    aff = affine(C)
    dwk = rnd(C, 1, 3, 3, scale=1 / 3, dtype=torch.float32)
    pwk = rnd(C, C, scale=C ** -0.5, dtype=torch.float32)

    for d in (2, 4, 8, 16):
        say(f"dwsep d={d:2d}", t(lambda d=d: R.dwsep_layer(
            x, aff, dwk, pwk, dilation=d)))
    for d in (2, 16):
        say(f"dwsep d={d:2d} B=2", t(lambda d=d: R.dwsep_layer(
            x2, aff, dwk, pwk, dilation=d)))

    # the "mxu" form: the same layer as one dense conv over pw . dw
    ck = pwk[:, :, None, None] * dwk[None, :, 0]
    for d in (2, 4, 8, 16):
        say(f"mxu-dense d={d:2d}", t(lambda d=d: R.dense_layer(
            x, ck, dilation=d, affine=aff)))
        say(f"mxu-dense d={d:2d} B=2", t(lambda d=d: R.dense_layer(
            x2, ck, dilation=d, affine=aff)))
    for rb in (64, 96):
        say(f"mxu-dense d=16 R={rb} B=2",
            note="n/a (no counterpart: block rows are a parameter of the "
                 "TPU row canvas)")

    # the dense layers at their three shapes
    x3 = rnd(1, 3, H, W)
    ek = rnd(C, 3, 3, 3, scale=(2 / 27) ** 0.5, dtype=torch.float32)
    say("dense 3->32 d1", t(lambda: R.dense_layer(x3, ek, dilation=1)))
    x64 = rnd(1, 2 * C, H, W)
    hk = rnd(C, 2 * C, 3, 3, scale=(2 / (9 * 2 * C)) ** 0.5,
             dtype=torch.float32)
    aff64 = affine(2 * C)
    say("dense 64->32 d8", t(lambda: R.dense_layer(x64, hk, dilation=8,
                                                   affine=aff64)))
    ok = rnd(1, C, 3, 3, scale=(2 / (9 * C)) ** 0.5, dtype=torch.float32)
    say("dense 32->1 d1", t(lambda: R.dense_layer(
        x, ok, dilation=1, out_dtype=torch.float32)))

    # the head entry: concat + dense against the two-input conv
    say("concat+dense 64->32 d8", t(lambda: R.dense_layer(
        torch.cat([x2[:1], x2[1:]], 1), hk, dilation=8, affine=aff64)))
    say("dense2 64->32 d8", t(lambda: R.dense2_layer(
        x2, hk, dilation=8, affine=aff64)))

    # paired against unpaired tower pairs at batch 2
    for d1, d2 in ((2, 4), (8, 16)) if cli.full else ((2, 4),):
        say(f"dwsep2 ({d1:2d},{d2:2d}) B=2", t(lambda d1=d1, d2=d2:
            R.dwsep2_layer(x2, aff, dwk, pwk, aff, dwk, pwk,
                           dilation1=d1, dilation2=d2)))
        say(f"solo+solo ({d1:2d},{d2:2d}) B=2", t(lambda d1=d1, d2=d2:
            R.dwsep_layer(R.dwsep_layer(x2, aff, dwk, pwk, dilation=d1),
                          aff, dwk, pwk, dilation=d2)))
        if cli.full:
            say(f"dwsep2 ({d1:2d},{d2:2d}) R=96 B=2",
                note="n/a (no counterpart: block rows are a parameter of "
                     "the TPU row canvas)")

    # the layout steps: the port has no canvas
    img = rnd(1, H, W, 3, dtype=torch.float32)
    say("to_canvas 3ch (stand-in: NHWC f32 -> NCHW bf16 permute)",
        t(lambda: img.permute(0, 3, 1, 2).to(dt).contiguous()))
    say("from_canvas 1ch",
        note="n/a (no counterpart: a 1-channel NCHW output is NHWC in "
             "memory, so the port's permute is a view)")
    say("dwt broadcast", note="n/a (no counterpart: the kernels stage the "
        "(C, 9) taps in shared memory)")
    say("aff broadcast", note="n/a (no counterpart: the kernels stage the "
        "(2, C) affines in shared memory)")

    # the probe: a (C, 1) -> (C, N) broadcast inside a kernel
    v = rnd(C, 1)
    got = lane_broadcast(v, 1024)
    torch.cuda.synchronize()
    good = torch.equal(got, lane_broadcast_plain(v, 1024))
    say("in-kernel (C,1)->(C,N) lane broadcast",
        note="OK" if good else "WRONG RESULT")
    if not good:
        raise RuntimeError("lane_broadcast disagrees with its plain version")

    # the whole refinement for context
    model = LWSNet(ModelConfig(), device=dev, seed=0)
    left = rnd(1, H, W, 3, dtype=torch.float32)
    disp = torch.as_tensor(gen.uniform(0, 100, (1, H, W, 1)),
                           dtype=torch.float32, device=dev)
    with torch.inference_mode():
        for label, kw in (
                ("rows paired=1", dict(mode="rows", dw="vpu", paired=True)),
                ("rows paired=0", dict(mode="rows", dw="vpu", paired=False)),
                ("rows mxu", dict(mode="rows", dw="mxu")),
                ("rows chain", dict(mode="rows", dw="chain")),
                ("layers", dict(mode="layers"))):
            say(f"refine_residual {label}", t(
                lambda kw=kw: refine_residual(model, left, disp, **kw),
                iters=20))

    out = {"device": torch.cuda.get_device_name(0), "card": smi,
           "input": f"{H}x{W}", "unit": "ms", "probe": "OK",
           "timings": results}
    if cli.json:
        with open(cli.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {cli.json}")
    return out


if __name__ == "__main__":
    main()
