"""Host-side image loading and eval transforms (numpy, HWC).

The port's own copy of the eval subset of the JAX package's
`data/transforms.py`: decode to [0, 1], ImageNet normalization, and the
deterministic bottom-right eval crop.
"""

from __future__ import annotations

import numpy as np

from lwsnet_tpu_torch.data import png as stdpng

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _decode_u8(path: str) -> np.ndarray:
    """HWC uint8 RGB: PIL when installed, else the stdlib PNG codec."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
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
    return _decode_u8(path).astype(np.float32) / 255.0


def normalize(img: np.ndarray) -> np.ndarray:
    """ImageNet-normalize an HWC [0, 1] image."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD


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
