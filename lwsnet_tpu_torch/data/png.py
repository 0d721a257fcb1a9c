"""Dependency-free PNG codec (stdlib zlib + numpy).

Last-resort fallback of the image-IO chain (native C++ decoder -> PIL ->
this), so the framework's data path has zero hard third-party image
dependencies. Covers every PNG shape the stereo pipeline touches
(reference: dataloader/dataloader.py:18-19, 54-56; inference.py:90,113-122):

* 8-bit RGB / RGBA / grayscale / indexed (KITTI camera frames, golden pair)
* 16-bit grayscale (KITTI disparity maps, uint16 = disp * 256)

Decoding reconstructs all five PNG filter types; rows filtered with None /
Sub / Up are fully vectorized (Sub via per-byte-lane cumulative sums), and
only Average/Paeth rows fall back to a per-byte Python loop. Interlaced
(Adam7) images are rejected — nothing in the stereo corpora uses them.

Encoding writes filter-0 scanlines with stdlib zlib; supports uint8
gray/RGB/RGBA and uint16 gray, enough for colormapped disparity PNGs and
KITTI submission format (reference: inference.py:113-122).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# color type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    """Yield (type, payload) chunks; stops at IEND. CRCs are not verified
    (we only read trusted local corpora; zlib would reject corrupt IDAT)."""
    pos = len(_SIGNATURE)
    n = len(data)
    while pos + 8 <= n:
        (length,), ctype = struct.unpack(">I", data[pos:pos + 4]), \
            data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        yield ctype, payload
        if ctype == b"IEND":
            return


def _unfilter(raw: np.ndarray, height: int, stride: int,
              bpp: int) -> np.ndarray:
    """Reverse per-scanline filtering. raw: (height, 1 + stride) uint8 rows
    (filter byte + data). Returns (height, stride) uint8."""
    ftypes = raw[:, 0]
    data = raw[:, 1:].astype(np.int32)  # headroom for mod-256 arithmetic
    out = np.zeros((height, stride), dtype=np.int32)
    prev = np.zeros(stride, dtype=np.int32)
    for y in range(height):
        f = ftypes[y]
        row = data[y]
        if f == 0:  # None
            rec = row
        elif f == 2:  # Up
            rec = (row + prev) & 0xFF
        elif f == 1:  # Sub: rec[x] = row[x] + rec[x-bpp] -> per-lane cumsum
            rec = row.reshape(-1, bpp)
            rec = np.cumsum(rec, axis=0, dtype=np.int64).reshape(-1) & 0xFF
        elif f == 3:  # Average
            rec = np.empty(stride, dtype=np.int32)
            for x in range(stride):
                a = rec[x - bpp] if x >= bpp else 0
                rec[x] = (row[x] + ((a + prev[x]) >> 1)) & 0xFF
        elif f == 4:  # Paeth
            rec = np.empty(stride, dtype=np.int32)
            for x in range(stride):
                a = rec[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                if pa <= pb and pa <= pc:
                    pr = a
                elif pb <= pc:
                    pr = b
                else:
                    pr = c
                rec[x] = (row[x] + pr) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {f} on row {y}")
        out[y] = rec
        prev = rec
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file to a numpy array.

    Returns (H, W) for grayscale, (H, W, C) for RGB/RGBA/gray+alpha;
    dtype uint8 or uint16 per the file's bit depth. Indexed-color images
    are expanded through their palette to RGB uint8.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")

    width = height = bit_depth = color_type = interlace = None
    palette = None
    idat = []
    for ctype, payload in _chunks(data):
        if ctype == b"IHDR":
            width, height, bit_depth, color_type, _, _, interlace = \
                struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
    if width is None or not idat:
        raise ValueError(f"{path}: missing IHDR/IDAT")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG unsupported")
    if color_type not in _CHANNELS:
        raise ValueError(f"{path}: color type {color_type} unsupported")
    if bit_depth not in (8, 16) and not (color_type == 3 and bit_depth <= 8):
        raise ValueError(f"{path}: bit depth {bit_depth} unsupported")

    nch = _CHANNELS[color_type]
    if color_type == 3 and bit_depth < 8:
        raise ValueError(f"{path}: sub-byte palette depth unsupported")
    bytes_per_sample = bit_depth // 8
    stride = width * nch * bytes_per_sample
    bpp = max(1, nch * bytes_per_sample)

    plain = zlib.decompress(b"".join(idat))
    expected = height * (stride + 1)
    if len(plain) < expected:
        raise ValueError(f"{path}: truncated IDAT "
                         f"({len(plain)} < {expected} bytes)")
    raw = np.frombuffer(plain[:expected], np.uint8).reshape(height,
                                                            stride + 1)
    flat = _unfilter(raw, height, stride, bpp)

    if bit_depth == 16:
        arr = flat.reshape(height, width, nch, 2)
        arr = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
    else:
        arr = flat.reshape(height, width, nch)
    if color_type == 3:
        if palette is None:
            raise ValueError(f"{path}: indexed PNG without PLTE")
        arr = palette[arr[..., 0]]
    return arr[..., 0] if (arr.ndim == 3 and arr.shape[2] == 1) else arr


def write_png(path: str, arr: np.ndarray, compress_level: int = 6) -> None:
    """Encode a numpy array as PNG. Accepts uint8 (H,W) / (H,W,3) / (H,W,4)
    and uint16 (H,W); scanlines use filter 0 (None)."""
    arr = np.ascontiguousarray(arr)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[2] not in (1, 3, 4):
        raise ValueError(f"unsupported array shape {arr.shape}")
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    if arr.dtype == np.uint8:
        depth, payload = 8, arr
    elif arr.dtype == np.uint16:
        if c != 1:
            raise ValueError("16-bit PNG write supports grayscale only")
        depth = 16
        payload = np.stack([(arr >> 8).astype(np.uint8),
                            (arr & 0xFF).astype(np.uint8)], axis=-1)
    else:
        raise ValueError(f"unsupported dtype {arr.dtype}")

    rows = payload.reshape(h, -1)
    scan = np.zeros((h, rows.shape[1] + 1), dtype=np.uint8)
    scan[:, 1:] = rows
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(scan.tobytes(), compress_level)))
        f.write(chunk(b"IEND", b""))
