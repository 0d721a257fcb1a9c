"""ctypes binding for the native data-path library (native/libstereoload.so).

Provides `decode_png` (8-bit RGB images, 16-bit KITTI disparity) and the
fused `crop_normalize_u8` / `crop_disparity_u16` passes. The transforms in
`lwsnet_tpu_torch.data.transforms` (`decode_image_u8`, `crop_normalize`,
`load_crop_disparity_kitti`) route through these automatically and fall back
to PIL/numpy when the library hasn't been built (`make -C native`). The
port's copy of the JAX package's binding; both load the same library.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "libstereoload.so")

_lib = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.lws_png_info.restype = ctypes.c_int
    lib.lws_png_info.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.lws_png_decode.restype = ctypes.c_int
    lib.lws_png_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p]
    lib.lws_crop_normalize_u8.restype = None
    lib.lws_crop_normalize_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.lws_crop_disparity_u16.restype = None
    lib.lws_crop_disparity_u16.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def decode_png(path: str) -> np.ndarray:
    """Decode a PNG to (H, W, C) uint8 or (H, W[, C]) uint16 (16-bit files).
    Raises ValueError on unsupported/corrupt files."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built (make -C native)")
    with open(path, "rb") as f:
        blob = f.read()
    w = ctypes.c_int()
    h = ctypes.c_int()
    ch = ctypes.c_int()
    depth = ctypes.c_int()
    if lib.lws_png_info(blob, len(blob), ctypes.byref(w), ctypes.byref(h),
                        ctypes.byref(ch), ctypes.byref(depth)) != 0:
        raise ValueError(f"{path}: unsupported or corrupt PNG")
    dtype = np.uint8 if depth.value == 8 else np.uint16
    out = np.empty((h.value, w.value, ch.value), dtype=dtype)
    rc = lib.lws_png_decode(blob, len(blob),
                            out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"{path}: PNG decode failed (code {rc})")
    if ch.value == 1:
        out = out[..., 0]
    return out


def crop_normalize_u8(img: np.ndarray, y0: int, x0: int, ch: int, cw: int,
                      mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """Fused crop + /255 + normalize of an HWC uint8 image -> HWC(3) f32."""
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(img)
    h, w, c = img.shape
    out = np.empty((ch, cw, 3), dtype=np.float32)
    m = np.ascontiguousarray(mean, dtype=np.float32)
    s = np.ascontiguousarray(std, dtype=np.float32)
    lib.lws_crop_normalize_u8(
        img.ctypes.data_as(ctypes.c_void_p), h, w, c, y0, x0, ch, cw,
        m.ctypes.data_as(ctypes.c_void_p), s.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p))
    return out


def crop_disparity_u16(disp: np.ndarray, y0: int, x0: int, ch: int,
                       cw: int) -> np.ndarray:
    """Fused crop + /256 of a uint16 KITTI disparity map -> HW f32."""
    lib = _load()
    assert lib is not None
    disp = np.ascontiguousarray(disp)
    h, w = disp.shape
    out = np.empty((ch, cw), dtype=np.float32)
    lib.lws_crop_disparity_u16(
        disp.ctypes.data_as(ctypes.c_void_p), h, w, y0, x0, ch, cw,
        out.ctypes.data_as(ctypes.c_void_p))
    return out
