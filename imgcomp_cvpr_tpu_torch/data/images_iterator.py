"""Validation image iteration with padding and an in-memory cache (own copy
of imgcomp_cvpr_tpu/data/images_iterator.py; ref: images_iterator.py:7-88).

Images are padded (centred, constant 0) so H and W are multiples of the
autoencoder's subsampling factor; alpha channels are dropped and grey images
become RGB. ``iter_padded`` yields HWC uint8 arrays with the pad geometry, so
metrics and saved outputs can undo the pad.
"""

from __future__ import annotations

from os import path
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def add_padding(im: np.ndarray, factor: int) -> Tuple[np.ndarray, Callable]:
    """Pad an HWC (or HW grey) image, centred with constant 0, to multiples
    of ``factor``; returns (padded, undo_pad) (ref: images_iterator.py:39-59)."""
    if im.ndim == 2:
        im = np.stack([im] * 3, axis=-1)
    if im.shape[2] == 4:
        im = im[:, :, :3]
    h, w, _ = im.shape
    hp = (factor - h % factor) % factor
    wp = (factor - w % factor) % factor
    if hp == 0 and wp == 0:
        return im, lambda x: x
    hp_lo, hp_hi = hp // 2, hp - hp // 2
    wp_lo, wp_hi = wp // 2, wp - wp // 2
    im = np.pad(im, [[hp_lo, hp_hi], [wp_lo, wp_hi], [0, 0]], mode='constant')

    def undo_pad(x: np.ndarray) -> np.ndarray:
        return x[hp_lo:(-hp_hi or None), wp_lo:(-wp_hi or None), :]
    return im, undo_pad


class ImagesIterator:
    """Iterates (img_name, padded HWC uint8) with an in-RAM cache, used when
    the whole set fits in ``cache_max_mb``."""

    def __init__(self, images_paths: Sequence[str], dataset_name: str,
                 cache_max_mb: int = 500):
        if len(images_paths) == 0:
            raise ValueError('No images!')
        self.images_paths = list(images_paths)
        self.dataset_name = dataset_name
        self.cache_max_mb = cache_max_mb
        self._cache: Optional[List[Optional[tuple]]] = None
        self._cache_pad: Optional[int] = None

    def _load(self, idx: int, pad: int) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
        if self._cache is not None and self._cache[idx] is not None:
            return self._cache[idx]
        from PIL import Image
        with Image.open(self.images_paths[idx]) as im:
            arr = np.asarray(im.convert('RGB'), np.uint8)
        oh, ow = arr.shape[:2]
        arr, _ = add_padding(arr, pad)
        hp_lo = (arr.shape[0] - oh) // 2
        wp_lo = (arr.shape[1] - ow) // 2
        item = (arr, (hp_lo, wp_lo, oh, ow))
        if self._cache is not None:
            self._cache[idx] = item
        return item

    def iter_imgs(self, pad: int) -> Iterator[Tuple[str, np.ndarray]]:
        for name, arr, _ in self.iter_padded(pad):
            yield name, arr

    def iter_padded(self, pad: int
                    ) -> Iterator[Tuple[str, np.ndarray, Tuple[int, int, int, int]]]:
        """Yields (name, padded HWC uint8, (hp_lo, wp_lo, orig_h, orig_w))."""
        if self._cache is None or self._cache_pad != pad:
            from PIL import Image
            with Image.open(self.images_paths[0]) as im0:
                num_pixels = im0.size[0] * im0.size[1]
            total_bytes = len(self.images_paths) * num_pixels * 3
            use_cache = total_bytes <= self.cache_max_mb * 1000 * 1000
            self._cache = [None] * len(self.images_paths) if use_cache else None
            self._cache_pad = pad
        for i, p in enumerate(self.images_paths):
            arr, pad_info = self._load(i, pad)
            yield path.basename(p), arr, pad_info

    def __str__(self) -> str:
        return f'Dataset {self.dataset_name}, {len(self.images_paths)} paths'
