"""JET colormap + disparity visualization without OpenCV.

The reference visualizes disparities with cv2's COLORMAP_JET applied to a
uint8 cast (reference: inference.py:113-122). cv2 isn't a dependency here, so
this reimplements OpenCV's JET table analytically. `colorize_disparity`
reproduces the reference's uint8 saturation cast by default.
"""

from __future__ import annotations

import numpy as np


def jet_colormap() -> np.ndarray:
    """(256, 3) uint8 BGR-ordered-as-RGB JET table (red = high).

    OpenCV's JET: piecewise-linear ramps through blue -> cyan -> yellow ->
    red over [0, 255].
    """
    x = np.arange(256, dtype=np.float64) / 255.0
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0.0, 1.0)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0.0, 1.0)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0.0, 1.0)
    return (np.stack([r, g, b], axis=-1) * 255.0 + 0.5).astype(np.uint8)


_JET = None


def colorize_disparity(disp: np.ndarray, max_disp: float = 0.0) -> np.ndarray:
    """Map an (H, W) disparity to an (H, W, 3) uint8 RGB JET image.

    The reference casts with `astype(np.uint8)` (reference: inference.py:114),
    which *wraps* slightly-negative stage outputs to 255; we clip instead —
    a conscious fix (SURVEY.md §7 quirks list). Passing max_disp scales
    [0, max_disp] onto the full table instead.
    """
    global _JET
    if _JET is None:
        _JET = jet_colormap()
    if max_disp > 0:
        idx = np.clip(disp / max_disp * 255.0, 0, 255).astype(np.uint8)
    else:
        idx = np.clip(disp, 0, 255).astype(np.uint8)
    return _JET[idx]
