"""KITTI2015 corpus indexing (reference: dataloader/kitti2015load.py:6-35).

The port's copy of the JAX package's `data/kitti2015.py`.

The published 2.87% number is measured on a fixed 40-frame validation split
(reference: val_set.txt, README.md:134-135); those frame indices are embedded
here as the default so results are reproducible without the side file. A
`split_file` still overrides, and `split_file=None, random_split=True`
reproduces the reference's random-40 fallback
(reference: dataloader/kitti2015load.py:14-17).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

# The reference's published validation frames (reference: val_set.txt:1-40).
DEFAULT_VAL_FRAMES: Sequence[int] = (
    13, 32, 36, 37, 38, 43, 46, 54, 58, 62, 75, 76, 79, 82, 92, 93, 99, 106,
    108, 114, 115, 117, 124, 131, 135, 138, 139, 141, 144, 148, 159, 162,
    164, 167, 176, 179, 182, 192, 193, 199,
)


@dataclass(frozen=True)
class StereoIndex:
    """Path triplets for a stereo split."""

    left: List[str]
    right: List[str]
    disp: List[str]

    def __len__(self):
        return len(self.left)


def index_kitti2015(datapath: str,
                    split_file: Optional[str] = None,
                    random_split: bool = False,
                    seed: int = 0) -> tuple:
    """Index KITTI2015 `training/` into (train, val) StereoIndex pairs.

    Layout: image_2/ image_3/ disp_occ_0/ with `*_10.png` frames
    (reference: dataloader/kitti2015load.py:7-12).
    """
    left_dir, right_dir, disp_dir = "image_2", "image_3", "disp_occ_0"
    frames = sorted(f for f in os.listdir(os.path.join(datapath, left_dir))
                    if "_10" in f)

    if split_file:
        with open(split_file) as f:
            val_ids = sorted(int(x.strip()) for x in f if x.strip())
    elif random_split:
        rng = np.random.default_rng(seed)
        val_ids = sorted(rng.permutation(200)[:40].tolist())
    else:
        val_ids = sorted(DEFAULT_VAL_FRAMES)

    val_names = {f"{i:06d}_10.png" for i in val_ids}
    train = [f for f in frames if f not in val_names]
    val = [f"{i:06d}_10.png" for i in sorted(val_ids)]

    def make(names):
        return StereoIndex(
            left=[os.path.join(datapath, left_dir, n) for n in names],
            right=[os.path.join(datapath, right_dir, n) for n in names],
            disp=[os.path.join(datapath, disp_dir, n) for n in names],
        )

    return make(train), make(val)


def index_kitti2015_testing(datapath: str) -> StereoIndex:
    """Index the GT-free `testing/` directory for batch inference
    (reference: inference.py:50-53)."""
    left_dir, right_dir = "image_2", "image_3"
    frames = sorted(os.listdir(os.path.join(datapath, left_dir)))
    return StereoIndex(
        left=[os.path.join(datapath, left_dir, n) for n in frames],
        right=[os.path.join(datapath, right_dir, n) for n in frames],
        disp=[],
    )
