"""Build, load and launch the port's hand-written CUDA kernels.

Each source in `lwsnet_tpu_torch/csrc/` is compiled by `nvcc` for `sm_90a`
into a shared library with a plain C interface, under `build/kernels/` at
the repository root, at first use. All sources build at once, one `nvcc`
process each. A library's file name carries a digest of its source, of
every header in `csrc/` and of the flags, so an edited source or header
builds anew. The libraries are loaded with `ctypes`; every C entry point
launches on the caller's stream and returns `cudaGetLastError()` (or the
error of a refused launch).

Each kernel keeps a launch counter: a wrapper adds one where it launches,
and nowhere else, so a run can show which kernels its path went through.
One source may hold several kernels (`dwsep3x3.cu`: the solo and the pair
layer), each with its own counter.

Layouts. A kernel reads and writes either the default (contiguous) layout
or channels-last memory ((B, H, W, C) / (B, D, H, W, C) under the logical
(B, C, ...) shape); the tensor-core routes take channels-last only. Where
a caller hands a kernel a layout it does not read, its wrapper makes one
copy with `in_layout`, which counts it in `LAYOUT_COPIES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("conv3d_bn_relu", "conv3d_skip_softargmin", "dense3x3",
           "dwsep3x3", "chain3x3", "lane_broadcast")
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
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
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
    """One kernel of a CUDA source: its C entry points and its launch
    counters (`launches` counts all; `dual_launches` those of a two-input
    call; `route_launches` those the wrapper names a route of, by route)."""

    def __init__(self, name: str, argtypes, source: str = ""):
        self.name = name
        self.lib_name = source or name
        self.source = f"lwsnet_tpu_torch/csrc/{self.lib_name}.cu"
        self.argtypes = argtypes
        self.launches = 0
        self.dual_launches = 0
        self.route_launches: Dict[str, int] = {}
        self._lib = None
        self._fns = {}

    def _fn(self, symbol: str):
        if symbol not in self._fns:
            if self._lib is None:
                path = _library_path(self.lib_name)
                if not path.exists():
                    build_all()
                self._lib = ctypes.CDLL(str(path))
            fn = getattr(self._lib, symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fns[symbol] = fn
        return self._fns[symbol]

    def launch(self, symbol: str, device: torch.device, *args,
               dual: bool = False, route: Optional[str] = None) -> None:
        """Call `symbol` with `args` and the current stream of `device`;
        raise if the launch was refused. `route`: the kernel's route the
        wrapper chose, counted in `route_launches`."""
        fn = self._fn(symbol)
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{symbol}: launch failed, cudaError {rc}")
        self.launches += 1
        self.dual_launches += dual
        if route is not None:
            self.route_launches[route] = self.route_launches.get(route, 0) + 1


CONV3D_BN_RELU = Kernel("conv3d_bn_relu", [_P] * 5 + [_I] * 8 + [_P])
CONV3D_SKIP_SOFTARGMIN = Kernel(
    "conv3d_skip_softargmin",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P])
DENSE3X3 = Kernel("dense3x3", [_P] * 7 + [_I] * 9 + [_P])
DWSEP3X3 = Kernel("dwsep3x3", [_P] * 5 + [_I] * 9 + [_P])
DWSEP3X3_PAIR = Kernel(
    "dwsep3x3_pair", [_P] * 8 + [_I] * 9 + [_P, _I, _I, _P],
    source="dwsep3x3")
_PP = ctypes.POINTER(ctypes.c_void_p)
_IP = ctypes.POINTER(ctypes.c_int)
CHAIN3X3 = Kernel(
    "chain3x3", [_I, _PP, _PP, _PP, _P, _P, _P, _PP, _IP, _IP, _IP, _I, _I,
                 _I, _I, _I, _P, _P])
LANE_BROADCAST = Kernel("lane_broadcast", [_P, _P, _I, _I, _P])
KERNELS = (CONV3D_BN_RELU, CONV3D_SKIP_SOFTARGMIN, DENSE3X3, DWSEP3X3,
           DWSEP3X3_PAIR, CHAIN3X3, LANE_BROADCAST)


def launch_counts() -> Dict[str, int]:
    """{kernel: launches}, plus "dense3x3[dual]" and "chain3x3[dual]" for
    two-input launches."""
    counts = {k.name: k.launches for k in KERNELS}
    for k in (DENSE3X3, CHAIN3X3):
        counts[f"{k.name}[dual]"] = k.dual_launches
    return counts


def route_counts() -> Dict[str, int]:
    """{"kernel[route]": launches} of every route a wrapper named, e.g.
    "dense3x3[entry]" and "dense3x3[output]" for dense3x3's narrow
    routes, "conv3d_bn_relu[entry]" for the cost filters' 1 -> C
    entries, "conv3d_bn_relu[cores]" and "conv3d_skip_softargmin[cores]"
    for the cost filters' other launches on the CUDA cores."""
    return {f"{k.name}[{r}]": n for k in KERNELS
            for r, n in sorted(k.route_launches.items())}


# Copies the wrappers made to hand a kernel the layout it reads.
LAYOUT_COPIES = {"to channels-last": 0, "to contiguous": 0}


def reset_launch_counts() -> None:
    """Set every launch counter and `LAYOUT_COPIES` to 0."""
    for k in KERNELS:
        k.launches = 0
        k.dual_launches = 0
        k.route_launches.clear()
    for k in LAYOUT_COPIES:
        LAYOUT_COPIES[k] = 0


def _format(ndim: int, channels_last: bool) -> torch.memory_format:
    if not channels_last:
        return torch.contiguous_format
    return torch.channels_last if ndim == 4 else torch.channels_last_3d


def lies_channels_last(t: torch.Tensor) -> bool:
    """Whether t lies channels-last in memory and not also contiguous."""
    return (not t.is_contiguous()
            and t.is_contiguous(memory_format=_format(t.dim(), True)))


def in_layout(t: torch.Tensor, channels_last: bool) -> torch.Tensor:
    """t itself where it already lies channels-last (or contiguous), else
    one copy that does, counted in `LAYOUT_COPIES`."""
    fmt = _format(t.dim(), channels_last)
    if t.is_contiguous(memory_format=fmt):
        return t
    LAYOUT_COPIES["to channels-last" if channels_last
                  else "to contiguous"] += 1
    return t.contiguous(memory_format=fmt)


def empty(shape, dtype: torch.dtype, device: torch.device,
          channels_last: bool) -> torch.Tensor:
    """An output tensor of logical `shape`, channels-last in memory or not."""
    return torch.empty(shape, dtype=dtype, device=device,
                       memory_format=_format(len(shape), channels_last))


def symbol_suffix(dtype: torch.dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.bfloat16:
        return "bf16"
    raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")


def check(t: torch.Tensor, name: str, shape, dtype: torch.dtype,
          device: torch.device, channels_last: bool = False) -> None:
    """Raise unless `t` is a tensor of this shape, dtype and device, dense
    in the default layout (or channels-last)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous(memory_format=_format(t.dim(), channels_last)):
        raise ValueError(f"{name}: not "
                         f"{'channels-last' if channels_last else 'contiguous'}")


def on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); anything else raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")
