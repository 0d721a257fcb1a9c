"""Host-side decode, crops and normalization (numpy, HWC).

The port's own copy of the JAX package's `data/transforms.py`: decode to
uint8, the fused crop + /255 + ImageNet normalization and crop + /256 of a
KITTI disparity map, SceneFlow's PFM disparity, the random training crop
and the deterministic bottom-right eval crop, which zero-pads the top and
left of a short image on request (SceneFlow's 540-row frames in a 544-row
window). Decoding goes native C++
(`native/libstereoload.so`, built by `make -C native`) -> PIL -> the
stdlib PNG codec; the crops go through the native library when it is
built and numpy otherwise. This is host decoding: nothing here touches a
device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from lwsnet_tpu_torch.data import native
from lwsnet_tpu_torch.data import png as stdpng
from lwsnet_tpu_torch.data.pfm import read_pfm

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _pil_image():
    """PIL's Image module when installed, else None."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def decode_image_u8(path: str) -> np.ndarray:
    """Decode an RGB image to HWC uint8: the native PNG decoder when built,
    then PIL, then the stdlib codec."""
    if native.available() and path.lower().endswith(".png"):
        try:
            raw = native.decode_png(path)
            if raw.dtype == np.uint8 and raw.ndim == 3 and raw.shape[2] >= 3:
                return np.ascontiguousarray(raw[..., :3])
        except ValueError:
            pass  # a PNG subformat the native decoder does not take
    Image = _pil_image()
    if Image is not None:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
    raw = stdpng.read_png(path)
    if raw.ndim == 2:
        raw = np.broadcast_to(raw[..., None], raw.shape + (3,))
    if raw.dtype == np.uint16:
        raw = (raw >> 8).astype(np.uint8)
    return np.ascontiguousarray(raw[..., :3].astype(np.uint8))


def load_image(path: str) -> np.ndarray:
    """Decode an RGB image to HWC float32 in [0, 1]."""
    return decode_image_u8(path).astype(np.float32) / 255.0


def normalize(img: np.ndarray) -> np.ndarray:
    """ImageNet-normalize an HWC [0, 1] image."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def crop_normalize(img_u8: np.ndarray, y0: int, x0: int, ch: int,
                   cw: int) -> np.ndarray:
    """Crop + /255 + ImageNet-normalize of a decoded HWC uint8 image, in
    one native pass over the window when the library is built."""
    if native.available():
        return native.crop_normalize_u8(img_u8, y0, x0, ch, cw,
                                        IMAGENET_MEAN, IMAGENET_STD)
    win = img_u8[y0:y0 + ch, x0:x0 + cw].astype(np.float32) / 255.0
    return normalize(win)


def load_disparity_kitti(path: str) -> np.ndarray:
    """KITTI disparity PNG as float32: uint16 / 256; 0 means no ground
    truth."""
    if native.available():
        try:
            raw = native.decode_png(path)
            if raw.dtype == np.uint16 and raw.ndim == 2:
                return raw.astype(np.float32) / 256.0
        except ValueError:
            pass
    Image = _pil_image()
    if Image is not None:
        with Image.open(path) as im:
            return np.asarray(im, dtype=np.float32) / 256.0
    return stdpng.read_png(path).astype(np.float32) / 256.0


def load_crop_disparity_kitti(path: str, y0: int, x0: int, ch: int,
                              cw: int) -> np.ndarray:
    """Decode + crop + /256 of a KITTI uint16 disparity PNG."""
    if native.available():
        try:
            raw = native.decode_png(path)
            if raw.dtype == np.uint16 and raw.ndim == 2:
                return native.crop_disparity_u16(raw, y0, x0, ch, cw)
        except ValueError:
            pass
    return load_disparity_kitti(path)[y0:y0 + ch, x0:x0 + cw]


def load_disparity_sceneflow(path: str) -> np.ndarray:
    """SceneFlow disparity PFM as float32 (reference:
    dataloader/dataloader.py:57-59)."""
    data, _ = read_pfm(path)
    return np.ascontiguousarray(data, dtype=np.float32)


def random_crop(left: np.ndarray, right: np.ndarray, disp: np.ndarray,
                height: int, width: int,
                rng: np.random.Generator) -> Tuple[np.ndarray, ...]:
    """Random aligned crop of the pair and its ground truth; draws y, then
    x (reference: dataloader/dataloader.py:61-70)."""
    h, w = left.shape[:2]
    y = int(rng.integers(0, h - height + 1))
    x = int(rng.integers(0, w - width + 1))
    return (left[y:y + height, x:x + width],
            right[y:y + height, x:x + width],
            disp[y:y + height, x:x + width])


def bottom_right_crop(img: np.ndarray, height: int, width: int,
                      pad_if_short: bool = False) -> np.ndarray:
    """Deterministic eval crop anchored bottom-right. pad_if_short=True
    zero-pads the top/left of an image smaller than the crop."""
    h, w = img.shape[:2]
    if h < height or w < width:
        if not pad_if_short:
            raise ValueError(
                f"image {h}x{w} smaller than crop {height}x{width}")
        pad = [(max(0, height - h), 0), (max(0, width - w), 0)]
        pad += [(0, 0)] * (img.ndim - 2)
        img = np.pad(img, pad)
        h, w = img.shape[:2]
    return img[h - height:h, w - width:w]
