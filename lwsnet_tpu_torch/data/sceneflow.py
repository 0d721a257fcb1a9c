"""SceneFlow corpus indexing (reference: dataloader/sceneflow.py:37-122).

The port's copy of the JAX package's `data/sceneflow.py`. It walks the
monkaa, FlyingThings (TRAIN/TEST, subsets A-B-C) and driving parts of a
SceneFlow root:

  <root>/
    monkaa_frames_cleanpass/<scene>/{left,right}/*.png
    monkaa_disparity/<scene>/left/*.pfm
    frames_cleanpass/{TRAIN,TEST}/{A,B,C}/<seq>/{left,right}/*.png
    frames_disparity/{TRAIN,TEST}/{A,B,C}/<seq>/left/*.pfm
    driving_frames_cleanpass/<focal>/<dir>/<speed>/{left,right}/*.png
    driving_disparity/...

FlyingThings TEST is the test split; everything else trains. The
reference indexes the driving 15mm focal-length split twice and never the
35mm one (reference: dataloader/sceneflow.py:105);
`compat_duplicate_15mm=True` reproduces that corpus, the default indexes
[15mm, 35mm].
"""

from __future__ import annotations

import os
from typing import List, Tuple

from lwsnet_tpu_torch.data.kitti2015 import StereoIndex

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp")


def _is_image(name: str) -> bool:
    return name.lower().endswith(_IMG_EXTS)


def _ls(path: str) -> List[str]:
    return sorted(os.listdir(path))


def index_sceneflow(root: str, compat_duplicate_15mm: bool = False
                    ) -> Tuple[StereoIndex, StereoIndex]:
    """Index a SceneFlow root into (train, test) StereoIndex triplets."""
    root = root.rstrip("/") + "/"
    entries = [d for d in _ls(root) if os.path.isdir(root + d)]
    image_dirs = [d for d in entries if "frames_cleanpass" in d]
    disp_dirs = [d for d in entries if "disparity" in d]
    train = ([], [], [])
    test = ([], [], [])

    def add(dst, img_dir, disp_dir):
        left_dir = os.path.join(img_dir, "left")
        right_dir = os.path.join(img_dir, "right")
        for im in _ls(left_dir):
            if not _is_image(im):
                continue
            dst[0].append(os.path.join(left_dir, im))
            dst[1].append(os.path.join(right_dir, im))
            dst[2].append(os.path.join(disp_dir, "left",
                                       im.split(".")[0] + ".pfm"))

    # monkaa (reference: dataloader/sceneflow.py:43-63)
    monkaa_img = [d for d in image_dirs if "monkaa" in d]
    if monkaa_img:
        mi = root + monkaa_img[0]
        md = root + [d for d in disp_dirs if "monkaa" in d][0]
        for scene in _ls(mi):
            add(train, os.path.join(mi, scene), os.path.join(md, scene))

    # FlyingThings TRAIN/TEST A-B-C (reference: dataloader/sceneflow.py:65-100)
    if "frames_cleanpass" in image_dirs:
        fi = root + "frames_cleanpass"
        fd = root + "frames_disparity"
        for split, dst in (("TRAIN", train), ("TEST", test)):
            for sub in ("A", "B", "C"):
                sub_dir = os.path.join(fi, split, sub)
                if not os.path.isdir(sub_dir):
                    continue
                for seq in _ls(sub_dir):
                    add(dst, os.path.join(sub_dir, seq),
                        os.path.join(fd, split, sub, seq))

    # driving (reference: dataloader/sceneflow.py:102-120)
    driving_img = [d for d in image_dirs if "driving" in d]
    if driving_img:
        di = root + driving_img[0]
        dd = root + [d for d in disp_dirs if "driving" in d][0]
        if compat_duplicate_15mm:
            focals = ["15mm_focallength", "15mm_focallength"]
        else:
            focals = [f for f in ("15mm_focallength", "35mm_focallength")
                      if os.path.isdir(os.path.join(di, f))]
        for focal in focals:
            for direction in ("scene_backwards", "scene_forwards"):
                for speed in ("fast", "slow"):
                    img_dir = os.path.join(di, focal, direction, speed)
                    if os.path.isdir(img_dir):
                        add(train, img_dir,
                            os.path.join(dd, focal, direction, speed))

    return StereoIndex(*train), StereoIndex(*test)
