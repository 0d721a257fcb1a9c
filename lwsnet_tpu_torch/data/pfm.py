"""PFM (portable float map) codec.

The port's copy of the JAX package's `data/pfm.py`: the format the
reference decodes (reference: dataloader/readpfm.py:6-42), a 'PF' (RGB) or
'Pf' (gray) magic line, a "width height" line and a scale whose sign gives
the byte order (negative: little-endian), then float32 rows stored bottom
to top. The writer makes little-endian files.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np


def read_pfm(path: str) -> Tuple[np.ndarray, float]:
    """Read a PFM file -> (HxW or HxWx3 float32 array, |scale|)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file (magic {header!r})")

        dims = f.readline().decode("ascii")
        m = re.match(r"^\s*(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM dims line {dims!r}")
        width, height = int(m.group(1)), int(m.group(2))

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        count = width * height * (3 if color else 1)
        data = np.fromfile(f, dtype=endian + "f4", count=count)
        if data.size != count:
            raise ValueError(f"{path}: truncated PFM payload")

    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).copy(), scale


def write_pfm(path: str, data: np.ndarray, scale: float = 1.0) -> None:
    """Write an HxW or HxWx3 array as little-endian float32 PFM."""
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 2:
        magic, shape = b"Pf", data.shape
    elif data.ndim == 3 and data.shape[2] == 3:
        magic, shape = b"PF", data.shape[:2]
    else:
        raise ValueError(f"unsupported PFM shape {data.shape}")
    with open(path, "wb") as f:
        f.write(magic + b"\n")
        f.write(f"{shape[1]} {shape[0]}\n".encode("ascii"))
        f.write(f"{-abs(scale)}\n".encode("ascii"))
        np.flipud(data).astype("<f4").tofile(f)
