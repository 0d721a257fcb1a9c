"""Build every kernel library ahead of time, without touching the card.

Counterpart of the JAX package's `examples/aot_warm.py`, which compiles
the inference program into JAX's persistent cache without running it. The
port's ahead-of-time step is `ops/cuda/build.build_all()`: nvcc for
sm_90a, every source at once, into `build/kernels/` (a library whose
source, headers and flags are unchanged is kept). It creates no CUDA
context, so it can run while another process holds the card. It prints
each library, whether this call built it or found it built, the wall
time of the whole build (the compilers run side by side, so that is the
figure that counts) and, where JAX printed the compiled program's
`cost_analysis` flops, the analytic conv FLOPs of the forward
(`utils.flops`):

    python -m lwsnet_tpu_torch.tools.aot_warm [--dw mxu] [--stages 4] \
        [--h 368] [--w 1232] [--batch 1]

`--dw` names the refinement engine of the forward whose FLOPs are
printed (every engine computes the same convolutions; every library is
built either way).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dw", type=str, default="mxu",
                    choices=["mxu", "vpu", "chain"])
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--h", type=int, default=368)
    ap.add_argument("--w", type=int, default=1232)
    ap.add_argument("--batch", type=int, default=1)
    args = ap.parse_args(argv)

    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.ops.cuda import build
    from lwsnet_tpu_torch.utils.flops import forward_flops

    cfg = ModelConfig(rows_dw=args.dw)
    present = {name for name in build.SOURCES
               if build._library_path(name).exists()}
    t0 = time.monotonic()
    build.build_all()
    wall = time.monotonic() - t0
    libraries = {}
    for name in build.SOURCES:
        path = build._library_path(name)
        libraries[name] = {"path": str(path), "built": name not in present}
        how = "already built" if name in present else "built"
        print(f"{name}: {path.name} ({how})")
    flops = forward_flops(cfg, args.h, args.w, args.batch, args.stages)
    print(f"built rows_dw={args.dw} stages={args.stages} "
          f"{args.h}x{args.w} libraries in {wall:.1f} s; "
          f"flops={flops:.3e} (analytic conv FLOPs, utils.flops)")
    return {"libraries": libraries, "seconds": wall, "flops": flops}


if __name__ == "__main__":
    main()
