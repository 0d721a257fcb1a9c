"""Build, load and launch the port's hand-written CUDA kernels.

Each source in `lwsnet_tpu_torch/csrc/` is compiled by `nvcc` for `sm_90a`
into a shared library with a plain C interface, under `build/kernels/` at
the repository root, at first use. All sources build at once, one `nvcc`
process each. A library's file name carries a digest of its sources and
flags, so an edited source builds anew. The libraries are loaded with
`ctypes`; every C entry point launches on the caller's stream and returns
`cudaGetLastError()`.

Each kernel keeps a launch counter: a wrapper adds one where it launches,
and nowhere else, so a run can show which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("conv3d_bn_relu", "conv3d_skip_softargmin", "dense3x3")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / "common.cuh").read_bytes())
    h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all `nvcc` processes
    started together. Returns {source: compiler output}, which holds the
    `-Xptxas -v` register and shared-memory lines."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = {}
    for name in SOURCES:
        so = _library_path(name)
        if so.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so)
    failed = []
    for name, (proc, tmp, so) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: _library_path(name).with_suffix(".log").read_text()
            for name in SOURCES}


class Kernel:
    """One CUDA source: its C entry points and its launch counters
    (`launches` counts all; `dual_launches` those of a two-input call)."""

    def __init__(self, name: str, argtypes):
        self.name = name
        self.source = f"lwsnet_tpu_torch/csrc/{name}.cu"
        self.argtypes = argtypes
        self.launches = 0
        self.dual_launches = 0
        self._lib = None
        self._fns = {}

    def _fn(self, symbol: str):
        if symbol not in self._fns:
            if self._lib is None:
                path = _library_path(self.name)
                if not path.exists():
                    build_all()
                self._lib = ctypes.CDLL(str(path))
            fn = getattr(self._lib, symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fns[symbol] = fn
        return self._fns[symbol]

    def launch(self, symbol: str, device: torch.device, *args,
               dual: bool = False) -> None:
        """Call `symbol` with `args` and the current stream of `device`;
        raise if the launch was refused."""
        fn = self._fn(symbol)
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{symbol}: launch failed, cudaError {rc}")
        self.launches += 1
        self.dual_launches += dual


CONV3D_BN_RELU = Kernel(
    "conv3d_bn_relu", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
CONV3D_SKIP_SOFTARGMIN = Kernel(
    "conv3d_skip_softargmin",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P])
DENSE3X3 = Kernel(
    "dense3x3", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])
KERNELS = (CONV3D_BN_RELU, CONV3D_SKIP_SOFTARGMIN, DENSE3X3)


def launch_counts() -> Dict[str, int]:
    """{kernel: launches}, plus "dense3x3[dual]" for two-input launches."""
    counts = {k.name: k.launches for k in KERNELS}
    counts["dense3x3[dual]"] = DENSE3X3.dual_launches
    return counts


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.dual_launches = 0


def symbol_suffix(dtype: torch.dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.bfloat16:
        return "bf16"
    raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")


def check(t: torch.Tensor, name: str, shape, dtype: torch.dtype,
          device: torch.device) -> None:
    """Raise unless `t` is a contiguous tensor of this shape, dtype and
    device."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); anything else raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")
