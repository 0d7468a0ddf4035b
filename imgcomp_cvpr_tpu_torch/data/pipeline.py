"""Training input pipeline (port of imgcomp_cvpr_tpu/data/pipeline.py; ref:
inputpipeline.py:15-213): host threads load images, take
``num_crops_per_img`` random crops + random horizontal flips, and assemble
NHWC uint8 batches into a bounded prefetch queue.

Only the procedural 'synthetic[:N]' dataset is ported: it needs no file.
Every other spec of the reference (image folders, globs, path lists,
TFRecord shards, 'natural') raises NotImplementedError.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

NUM_PREPROCESS_THREADS = int(os.environ.get('NUM_PREPROCESS_THREADS', 4))
NUM_CROPS_PER_IMG = int(os.environ.get('NUM_CROPS_PER_IMG', 1))


class Dataset:
    """A list of image sources with lazy decode."""

    def __init__(self, paths: Sequence[str], name: str):
        if len(paths) == 0:
            raise ValueError(f'empty dataset {name}')
        self.paths = list(paths)
        self.name = name

    @property
    def num_images(self) -> int:
        return len(self.paths)

    def load(self, idx: int) -> np.ndarray:
        """-> HWC uint8 RGB. Datasets read from files are not ported yet
        (ROADMAP Queue 1 #10); SyntheticDataset overrides this."""
        raise NotImplementedError(f'{self.name}: loading image files is not ported')


class SyntheticDataset(Dataset):
    """Procedural images; index-deterministic, no I/O; the same uint8
    images as the reference's SyntheticDataset."""

    def __init__(self, num_images: int = 64, hw: Tuple[int, int] = (256, 256),
                 name: str = 'synthetic'):
        super().__init__([f'synthetic://{i}' for i in range(num_images)], name)
        self._hw = hw
        self._cache: dict = {}

    def load(self, idx: int) -> np.ndarray:
        img = self._cache.get(idx)
        if img is None:
            img = self._generate(idx)
            if len(self._cache) < 512:
                self._cache[idx] = img
        return img

    def _generate(self, idx: int) -> np.ndarray:
        h, w = self._hw
        rng = np.random.RandomState(idx)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        freq = rng.rand(3, 4) * 0.2
        phase = rng.rand(3, 4) * 6.28
        img = np.zeros((h, w, 3), np.float32)
        for c in range(3):
            img[..., c] = (np.sin(yy * freq[c, 0] + phase[c, 0]) +
                           np.sin(xx * freq[c, 1] + phase[c, 1]) +
                           np.sin((xx + yy) * freq[c, 2] + phase[c, 2]))
        img = (img - img.min()) / max(float(np.ptp(img)), 1e-6) * 255.0
        noise = rng.randn(h, w, 3) * 8.0
        return np.clip(img + noise, 0, 255).astype(np.uint8)


def get_dataset(spec: str) -> Dataset:
    if spec == 'synthetic' or spec.startswith('synthetic:'):
        n = int(spec.split(':')[1]) if ':' in spec else 64
        return SyntheticDataset(num_images=n)
    raise NotImplementedError(
        f'dataset spec {spec!r}: only synthetic[:N] is ported; image folders, '
        f'globs, path lists, TFRecord shards and natural[:N] are queued '
        f'(ROADMAP Queue 1 #10)')


def random_crop_and_flip(img: np.ndarray, crop_hw: Tuple[int, int],
                         rng: np.random.RandomState, num_crops: int
                         ) -> List[np.ndarray]:
    """Random crops + 50% horizontal flip (ref: inputpipeline.py:199-213)."""
    ch, cw = crop_hw
    h, w = img.shape[:2]
    if h < ch or w < cw:  # upscale-pad small images by reflection
        img = np.pad(img, ((0, max(0, ch - h)), (0, max(0, cw - w)), (0, 0)),
                     mode='reflect')
        h, w = img.shape[:2]
    crops = []
    for _ in range(num_crops):
        y = rng.randint(0, h - ch + 1)
        x = rng.randint(0, w - cw + 1)
        crop = img[y:y + ch, x:x + cw]
        if rng.rand() < 0.5:
            crop = crop[:, ::-1]
        crops.append(np.ascontiguousarray(crop))
    return crops


class InputPipeline:
    """Yields (N, H, W, 3) uint8 batches (the device casts to float32: 4x
    less host->device transfer than shipping floats)."""

    def __init__(self, dataset: Dataset, crop_size: Tuple[int, int],
                 batch_size: int, shuffle: bool = True,
                 num_preprocess_threads: int = NUM_PREPROCESS_THREADS,
                 num_crops_per_img: int = NUM_CROPS_PER_IMG,
                 seed: int = 666, prefetch: int = 8):
        self.dataset = dataset
        self.crop_size = tuple(crop_size)
        self.batch_size = batch_size
        self.num_crops_per_img = num_crops_per_img
        self.shuffle = shuffle
        self.seed = seed
        self._num_threads = max(1, num_preprocess_threads)
        self._queue: 'queue.Queue[np.ndarray]' = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    def start(self) -> 'InputPipeline':
        for t in range(self._num_threads):
            th = threading.Thread(target=self._worker, args=(t,), daemon=True)
            th.start()
            self._threads.append(th)
        return self

    def stop(self) -> None:
        """Stop the workers and wait for them."""
        self._stop.set()
        # Drain so workers blocked on put() can exit.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        for th in self._threads:
            th.join(timeout=5.0)
        self._threads = []

    def _worker(self, worker_id: int) -> None:
        rng = np.random.RandomState(self.seed + worker_id)
        n = self.dataset.num_images
        order = np.arange(n)
        pos = n  # trigger reshuffle on first use
        buf: List[np.ndarray] = []
        while not self._stop.is_set():
            while len(buf) < self.batch_size:
                if pos >= n:
                    if self.shuffle:
                        rng.shuffle(order)
                    pos = 0
                img = self.dataset.load(int(order[pos]))
                pos += 1
                buf.extend(random_crop_and_flip(
                    img, self.crop_size, rng, self.num_crops_per_img))
            batch = np.stack(buf[:self.batch_size])  # uint8
            buf = buf[self.batch_size:]
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def get_batch(self, timeout: Optional[float] = 60.0) -> np.ndarray:
        return self._queue.get(timeout=timeout)

    def __iter__(self) -> Iterator[np.ndarray]:
        if not self._threads:
            self.start()
        while True:
            yield self.get_batch()
