"""Host-sharded, thread-prefetched input pipeline (KITTI2015, SceneFlow).

The port's copy of the JAX package's `data/pipeline.py`, which it matches
batch for batch:

* **Per-process slices**: each process reads the disjoint slice
  `order[process_index::process_count]` of the epoch's example order (the
  same seeded shuffle on every process).
* **Lockstep batch counts**: training drops the trailing partial batch;
  evaluation pads the last batch and marks the padding with `valid` 0.
  The count comes from the global example count, so every process runs
  the same number of steps.
* **Thread-pool decode + bounded prefetch queue**: decoding overlaps the
  device's work; threads suffice because decode releases the interpreter
  lock inside zlib, the native library and numpy.

Batches are numpy; the trainer moves them to the device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np

from lwsnet_tpu_torch.data import transforms as T
from lwsnet_tpu_torch.data.kitti2015 import StereoIndex


@dataclass(frozen=True)
class Batch:
    """One process-local batch, NHWC float32."""

    left: np.ndarray       # (B, H, W, 3) normalized
    right: np.ndarray      # (B, H, W, 3) normalized
    disparity: np.ndarray  # (B, H, W) float32; zeros where padded
    valid: np.ndarray      # (B,) 1.0 for real examples, 0.0 for padding


def _load_example(index: StereoIndex, i: int, training: bool,
                  crop: Tuple[int, int], kitti: bool,
                  rng: np.random.Generator
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One example: a random crop for training (y, then x, as
    `T.random_crop` draws them), the bottom-right one for evaluation.

    KITTI decodes to uint8, then one fused crop + normalize pass over the
    window. SceneFlow decodes the whole frame to float32 and its PFM
    ground truth; its eval crop zero-pads the top rows of a frame shorter
    than the window (544 rows from 540, as the reference gets from PIL,
    dataloader/dataloader.py:85) and keeps the full-size ground truth:
    the metric drops the prediction's top rows instead (reference:
    train.py:189)."""
    ch, cw = crop
    if not kitti:
        left = T.load_image(index.left[i])
        right = T.load_image(index.right[i])
        disp = (T.load_disparity_sceneflow(index.disp[i]) if index.disp
                else np.zeros(left.shape[:2], dtype=np.float32))
        if training:
            left, right, disp = T.random_crop(left, right, disp, ch, cw,
                                              rng)
        else:
            left = T.bottom_right_crop(left, ch, cw, pad_if_short=True)
            right = T.bottom_right_crop(right, ch, cw, pad_if_short=True)
        return T.normalize(left), T.normalize(right), disp
    left_u8 = T.decode_image_u8(index.left[i])
    right_u8 = T.decode_image_u8(index.right[i])
    h, w = left_u8.shape[:2]
    if training:
        y0 = int(rng.integers(0, h - ch + 1))
        x0 = int(rng.integers(0, w - cw + 1))
    else:
        y0, x0 = h - ch, w - cw
    left = T.crop_normalize(left_u8, y0, x0, ch, cw)
    right = T.crop_normalize(right_u8, y0, x0, ch, cw)
    if index.disp:
        disp = T.load_crop_disparity_kitti(index.disp[i], y0, x0, ch, cw)
    else:
        disp = np.zeros((ch, cw), dtype=np.float32)
    return left, right, disp


class StereoPipeline:
    """Iterable over process-local batches of one split: KITTI2015
    (`kitti=True`) or SceneFlow (PFM ground truth, padded eval crops)."""

    def __init__(self, index: StereoIndex, batch_size: int,
                 training: bool, crop: Tuple[int, int], kitti: bool = True,
                 seed: int = 0, num_workers: int = 8, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1):
        self.index = index
        self.batch_size = batch_size
        self.training = training
        self.crop = crop
        self.kitti = kitti
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.process_index = process_index
        self.process_count = process_count

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.index))
        if self.training:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        return order[self.process_index::self.process_count]

    def batches_per_epoch(self) -> int:
        """Per-process batch count, the same on every process: training
        floor-divides the shortest slice, evaluation ceil-divides the
        longest (short processes pad with valid 0 examples)."""
        n, pc = len(self.index), self.process_count
        if self.training:
            return (n // pc) // self.batch_size
        return -(-(-(-n // pc)) // self.batch_size)  # ceil(ceil(n/pc)/bs)

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        order = self._epoch_order(epoch)
        total = self.batches_per_epoch()
        order = order[: total * self.batch_size]
        if total == 0:
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        pool = ThreadPoolExecutor(max_workers=self.num_workers)

        def load_one(args):
            j, i = args
            rng = np.random.default_rng((self.seed, epoch, int(i), j))
            return _load_example(self.index, int(i), self.training,
                                 self.crop, self.kitti, rng)

        # Padding rows duplicate a real example (valid 0); a process whose
        # slice is empty still emits `total` all-padding batches.
        donor = int(order[0]) if len(order) else 0

        def put(item) -> bool:
            """Queue `item` unless the consumer stopped; False if so."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(total):
                    ids = list(order[b * self.batch_size:
                                     (b + 1) * self.batch_size])
                    n_real = len(ids)
                    ids += [donor] * (self.batch_size - n_real)
                    examples = list(pool.map(load_one, enumerate(ids)))
                    valid = (np.arange(self.batch_size) < n_real
                             ).astype(np.float32)
                    if not put(Batch(np.stack([e[0] for e in examples]),
                                     np.stack([e[1] for e in examples]),
                                     np.stack([e[2] for e in examples]),
                                     valid)):
                        return
                put(None)
            except Exception as e:  # surface decode errors to the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
            pool.shutdown(wait=True)
