"""Training input pipeline and dataset resolution (port of
imgcomp_cvpr_tpu/data/pipeline.py; ref: inputpipeline.py:15-213): host
threads load images, take ``num_crops_per_img`` random crops + random
horizontal flips, and assemble NHWC uint8 batches into a bounded prefetch
queue.

A dataset spec (``get_dataset``) may be
  - 'synthetic[:N]': deterministic procedural images (tests, benches);
  - 'natural[:N[:HxW]]': deterministic 1/f^2 natural-statistics images
    (data/natural.py);
  - a known TFRecord name ('imgnet_train', 'imgnet_test') resolved under
    $RECORDS_ROOT, or '*.tfrecord' shards: RecordsDataset reads them with a
    pure-Python framing walk and a persisted offset index, no tensorflow;
  - a directory (searched recursively for image files), a .pkl or .txt list
    of image paths, or a glob; a name relative to $RECORDS_ROOT as well.
Each spec resolves to the JAX package's images, in its order and under its
dataset name.
"""

from __future__ import annotations

import glob as glob_lib
import io
import os
import pickle
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import constants

_IMG_EXTS = ('.png', '.jpg', '.jpeg', '.bmp', '.ppm')


def _decode_rgb(source) -> np.ndarray:
    """A path or a file object of an encoded image -> HWC uint8 RGB."""
    from PIL import Image
    with Image.open(source) as im:
        return np.asarray(im.convert('RGB'), np.uint8)


class Dataset:
    """A list of image files with lazy decode."""

    def __init__(self, paths: Sequence[str], name: str):
        if len(paths) == 0:
            raise ValueError(f'empty dataset {name}')
        self.paths = list(paths)
        self.name = name

    @property
    def num_images(self) -> int:
        return len(self.paths)

    def load(self, idx: int) -> np.ndarray:
        """-> HWC uint8 RGB."""
        return _decode_rgb(self.paths[idx])


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


class NaturalDataset(Dataset):
    """Deterministic 1/f^2 natural-statistics images (data/natural.py);
    index-deterministic, no I/O. The uint8 cache (H W 3 bytes an image) is
    bounded by ``cache_max_mb``."""

    def __init__(self, num_images: int = 64, hw: Tuple[int, int] = (320, 320),
                 name: str = 'natural', cache_max_mb: int = 512):
        super().__init__([f'natural://{i}' for i in range(num_images)], name)
        self._hw = hw
        self._cache: dict = {}
        self._cache_max = max(1, (cache_max_mb * 1024 * 1024) // (hw[0] * hw[1] * 3))

    def load(self, idx: int) -> np.ndarray:
        img = self._cache.get(idx)
        if img is None:
            from . import natural
            img = natural.natural_image(idx, *self._hw)
            if len(self._cache) < self._cache_max:
                self._cache[idx] = img
        return img


def _scan_tfrecord_offsets(shard: str) -> np.ndarray:
    """Byte offset of every record in a TFRecord file, from the framing
    alone (u64 length + u32 crc | payload | u32 crc per record): one
    sequential pass, no payload decode."""
    offsets = []
    size = os.path.getsize(shard)
    with open(shard, 'rb') as f:
        pos = 0
        while pos + 12 <= size:
            offsets.append(pos)
            f.seek(pos)
            (length,) = np.frombuffer(f.read(8), np.uint64)
            pos += 8 + 4 + int(length) + 4
    if pos != size:
        raise ValueError(f'truncated/corrupt TFRecord: {shard}')
    return np.asarray(offsets, np.int64)


def tfrecord_index(shard: str) -> np.ndarray:
    """Record offsets of a shard, persisted beside it as ``<shard>.idx.npy``
    (built on first use, then memory-mapped); an unwritable directory keeps
    the index in memory."""
    idx_p = shard + '.idx.npy'
    try:
        if os.path.exists(idx_p) and (os.path.getmtime(idx_p)
                                      >= os.path.getmtime(shard)):
            return np.load(idx_p, mmap_mode='r')
    except OSError:
        pass
    offsets = _scan_tfrecord_offsets(shard)
    try:
        np.save(idx_p, offsets)
    except OSError:
        pass
    return offsets


class RecordsDataset(Dataset):
    """TFRecord shards of encoded images, the reference's training format
    (ref: inputpipeline.py:42-80; 'imgnet_train' = 1,281,167 images).

    The per-shard offset index makes init O(#shards) after the first run,
    and ``load`` is one seek and one record read. The tf.train.Example is
    unwrapped with a minimal protobuf walk (``example_bytes_feature``)."""

    KNOWN = {'imgnet_train': ('train-*.tfrecord', 1_281_167),
             'imgnet_test': ('val-*.tfrecord', 50_000)}

    # Per-(shard, thread) file handles, so that seeks from different
    # pipeline workers never share a file position; at most this many a
    # thread stay open.
    _MAX_OPEN_PER_THREAD = 16

    def __init__(self, shard_paths: Sequence[str], name: str,
                 feature_key: str = 'image/encoded'):
        if not shard_paths:
            raise ValueError(f'{name}: no shards')
        self._shards = list(shard_paths)
        self.feature_key = feature_key
        self._offsets = [tfrecord_index(s) for s in self._shards]
        counts = [len(o) for o in self._offsets]
        self._shard_of = np.repeat(np.arange(len(counts)), counts)
        self._base = np.concatenate([[0], np.cumsum(counts)])
        self._files: dict = {}
        self._files_lock = threading.Lock()
        super().__init__([f'{self._shards[s]}#{i - self._base[s]}'
                          for i, s in enumerate(self._shard_of)], name)

    def _file(self, shard_i: int):
        key = (shard_i, threading.get_ident())
        with self._files_lock:
            f = self._files.get(key)
            if f is None:
                mine = [k for k in self._files if k[1] == key[1]]
                if len(mine) >= self._MAX_OPEN_PER_THREAD:
                    self._files.pop(mine[0]).close()    # the oldest of this thread
                f = open(self._shards[shard_i], 'rb')
                self._files[key] = f
        return f

    def close(self) -> None:
        with self._files_lock:
            for f in self._files.values():
                f.close()
            self._files.clear()

    def __del__(self):
        files = getattr(self, '_files', {})
        for f in files.values():
            f.close()

    def _record(self, idx: int) -> bytes:
        shard_i = int(self._shard_of[idx])
        ordinal = idx - int(self._base[shard_i])
        f = self._file(shard_i)
        f.seek(int(self._offsets[shard_i][ordinal]))
        (length,) = np.frombuffer(f.read(8), np.uint64)
        f.seek(4, 1)  # length crc
        return f.read(int(length))

    def load(self, idx: int) -> np.ndarray:
        return _decode_rgb(io.BytesIO(example_bytes_feature(self._record(idx),
                                                            self.feature_key)))

    def shuffled_order(self, rng: np.random.RandomState) -> np.ndarray:
        """Shard-aware shuffle: shard order and order within a shard are
        random, but a shard's records stay together, so reads stay nearly
        sequential on disk."""
        blocks = []
        for s in rng.permutation(len(self._shards)):
            lo, hi = int(self._base[s]), int(self._base[s + 1])
            blocks.append(lo + rng.permutation(hi - lo))
        return np.concatenate(blocks)


def example_bytes_feature(record: bytes, want_key: str) -> bytes:
    """One bytes feature of a serialized tf.train.Example, by a minimal
    protobuf walk (Example{1: Features{1: map<string, Feature>}},
    Feature{1: BytesList{1: bytes}}). Falls back to the first bytes feature
    if want_key is absent."""

    def varint(buf, pos):
        out = shift = 0
        while True:
            b = buf[pos]
            pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out, pos
            shift += 7

    def fields(buf):
        pos = 0
        while pos < len(buf):
            tag, pos = varint(buf, pos)
            field, wire = tag >> 3, tag & 7
            if wire == 2:           # length-delimited
                ln, pos = varint(buf, pos)
                yield field, buf[pos:pos + ln]
                pos += ln
            elif wire == 0:         # varint
                _, pos = varint(buf, pos)
            else:
                raise ValueError(f'unsupported wire type {wire}')

    fallback = None
    for f1, features in fields(record):
        if f1 != 1:
            continue
        for f2, entry in fields(features):   # map entries
            if f2 != 1:
                continue
            key = value = None
            for fe, payload in fields(entry):
                if fe == 1:
                    key = payload.decode()
                elif fe == 2:
                    value = payload
            if value is None:
                continue
            for fv, blist in fields(value):  # Feature
                if fv != 1:                  # 1 = bytes_list
                    continue
                for fb, data in fields(blist):
                    if fb == 1:
                        if key == want_key:
                            return data
                        if fallback is None:
                            fallback = data
    if fallback is not None:
        return fallback
    raise ValueError(f'no bytes feature in record (wanted {want_key!r})')


def _image_files(directory: str) -> List[str]:
    return sorted(p for p in glob_lib.glob(os.path.join(directory, '**', '*'),
                                           recursive=True)
                  if p.lower().endswith(_IMG_EXTS))


def get_dataset(spec: str) -> Dataset:
    """Resolve a dataset spec (see the module docstring); raises ValueError
    when nothing matches."""
    if spec == 'synthetic' or spec.startswith('synthetic:'):
        n = int(spec.split(':')[1]) if ':' in spec else 64
        return SyntheticDataset(num_images=n)
    if spec == 'natural' or spec.startswith('natural:'):
        parts = spec.split(':')
        n = int(parts[1]) if len(parts) > 1 else 64
        hw = (320, 320)
        if len(parts) > 2:
            h, w = parts[2].lower().split('x')
            hw = (int(h), int(w))
        return NaturalDataset(num_images=n, hw=hw)
    if spec in RecordsDataset.KNOWN:
        pattern, _ = RecordsDataset.KNOWN[spec]
        shards = sorted(glob_lib.glob(os.path.join(constants.RECORDS_ROOT, pattern)))
        if shards:
            return RecordsDataset(shards, name=spec)
        raise ValueError(
            f'{spec!r}: no TFRecord shards matching {pattern} under '
            f'$RECORDS_ROOT={constants.RECORDS_ROOT}')
    if spec.endswith('.tfrecord') or '*.tfrecord' in spec:
        shards = sorted(glob_lib.glob(spec))
        if shards:
            return RecordsDataset(shards, name=os.path.basename(spec))
    for cand in (spec, os.path.join(constants.RECORDS_ROOT, spec)):
        if os.path.isdir(cand):
            return Dataset(_image_files(cand), name=os.path.basename(cand.rstrip(os.sep)))
        if os.path.isfile(cand) and cand.endswith('.pkl'):
            with open(cand, 'rb') as f:
                return Dataset(pickle.load(f), name=os.path.basename(cand))
        if os.path.isfile(cand) and cand.endswith('.txt'):
            with open(cand) as f:
                return Dataset([line.strip() for line in f if line.strip()],
                               name=os.path.basename(cand))
    matches = sorted(glob_lib.glob(spec))
    if matches:
        return Dataset(matches, name='glob')
    raise ValueError(f'Cannot resolve dataset spec {spec!r}')


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
                 num_preprocess_threads: int = constants.NUM_PREPROCESS_THREADS,
                 num_crops_per_img: int = constants.NUM_CROPS_PER_IMG,
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
                        if isinstance(self.dataset, RecordsDataset):
                            order = self.dataset.shuffled_order(rng)
                        else:
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
