#!/usr/bin/env python3
"""Each port kernel alone on one GPU, at every shape its paths give it.

Run from the repository root on a machine with a card:

    python3 kernel_device_times.py [--package-root DIR] [--nchw]
                                   [--json PATH]

For every kernel call of `chip_smoke.py` (phases 3 and 6: the 368x1232
batch-1 bf16 forward under each refinement path, the "layers" refinement
at 96x3712) it builds the same seeded operands and prints the device time
of the kernel alone, from one torch.profiler window over 10 calls after a
warm-up (`chip_smoke.kernel_device_ms`): without the wrapper's host time,
which a pair of events around one call also counts, and without the
wrappers' layout copies and weight re-layouts, which are separate kernels.

--package-root DIR imports `lwsnet_tpu_torch` from another checkout (for
instance the parent commit unpacked with `git archive`), so two trees can
be compared on one card in one run; --nchw hands every kernel NCHW
operands, as a checkout without channels-last routes needs. Exits 1
without CUDA.
"""

import argparse
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package-root", default=None)
    ap.add_argument("--nchw", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_device_times: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs  # this checkout's, before the package's root
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    import lwsnet_tpu_torch
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.utils.timing import card

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = ModelConfig()
    calls = (cs.main_path_calls(cfg) + cs.variant_calls(cfg)
             + cs.layers_calls(cfg))
    rows = []
    root = os.path.dirname(lwsnet_tpu_torch.__file__)
    print(f"card: {card()}; package {root}")
    for i, (kernel, label, p, n, engine) in enumerate(calls):
        if args.nchw:
            p = {k: v for k, v in p.items() if k not in ("cl", "cl_out")}
        c = cs.make_call(kernel, p, torch.bfloat16,
                         np.random.default_rng(2000 + i), dev)
        ms = cs.kernel_device_ms(c["kernel"], cs.KERNEL_NAMES[kernel])
        del c
        rows.append(dict(kernel=kernel, label=label, engine=engine,
                         launches=n, device_ms=ms))
        print(f"{kernel} [{label}] x{n} ({engine}): "
              f"{'not measured' if ms is None else f'{ms:.4f} ms'}")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=card(), rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
