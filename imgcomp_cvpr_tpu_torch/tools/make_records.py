"""Pack image files into TFRecord shards — the dataset-prep step (port of
imgcomp_cvpr_tpu/tools/make_records.py: the same shard bytes).

The reference prepares ImageNet with an external toolchain (ref
README.md:139-212: GNU parallel + ImageMagick `convert -resize "256x256^"`
+ `python -m fjcommon tf_records mk_img_rec`); this tool is the
self-contained equivalent: optional shorter-side resize and record
packing in one command, parallel over worker processes, producing shards
that `data/pipeline.py::RecordsDataset` (and TensorFlow's own readers)
consume directly. The per-shard offset index (`<shard>.idx.npy`) is
built eagerly so training init never pays the first-scan cost.

Records are `tf.train.Example` protos with one bytes feature (default
key ``image/encoded``), serialized by a minimal hand-rolled proto
encoder (the exact mirror of `pipeline.example_bytes_feature`'s walk).
Framing is always the pure-Python writer (u64 length + masked-CRC32C
framing), byte-identical to TensorFlow's `TFRecordWriter`; the port never
imports tensorflow.

Usage:
    python -m imgcomp_cvpr_tpu_torch.tools.make_records 'data/train/**/*.JPEG' \
        -o records/train --prefix train --num_per_shard 1250 --resize 256
"""

from __future__ import annotations

import argparse
import functools
import glob
import io
import os
import struct
import sys
from multiprocessing import get_context
from typing import List, Sequence

import numpy as np

_FEATURE_KEY = 'image/encoded'
# Shard granularity of the reference recipe (README.md:196: parallel -N 1250).
_NUM_PER_SHARD = 1250


# -- minimal tf.train.Example encoding ---------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def serialize_example(img_bytes: bytes, key: str = _FEATURE_KEY) -> bytes:
    """Example{1: Features{1: map entry{1: key, 2: Feature{1: BytesList{1:
    bytes}}}}} — the shape `pipeline.example_bytes_feature` walks."""
    bytes_list = _len_delim(1, img_bytes)
    feature = _len_delim(1, bytes_list)
    entry = _len_delim(1, key.encode()) + _len_delim(2, feature)
    features = _len_delim(1, entry)
    return _len_delim(1, features)


# -- TFRecord framing ------------------------------------------------------------

_CRC_POLY = 0x82F63B78                      # Castagnoli, reflected
_CRC_CHUNKS = 4096      # byte strings this long and longer run chunk-parallel


@functools.lru_cache(maxsize=None)
def _crc32c_table() -> np.ndarray:
    table = np.zeros(256, np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_CRC_POLY if crc & 1 else 0)
        table[i] = crc
    return table


def _crc_bytes(state, data: np.ndarray) -> np.ndarray:
    """The CRC register after the columns of ``data``: ``state`` (n,) uint32,
    ``data`` (n, m) uint8, one register a row (no pre- or post-inversion)."""
    tbl = _crc32c_table()
    state = np.asarray(state, np.uint32)
    for j in range(data.shape[1]):
        state = tbl[(state ^ data[:, j]) & 0xFF] ^ (state >> np.uint32(8))
    return state


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``, as TFRecord and TF's tensor bundles
    store it. A long string is cut into _CRC_CHUNKS rows of m bytes whose
    registers (from 0) advance together; the register is linear over GF(2),
    so crc(a | b) = Z_m crc(a) ^ crc0(b), with Z_m the matrix of m zero bytes,
    folds them in order. The m * _CRC_CHUNKS bytes' tail runs byte by byte."""
    buf = np.frombuffer(data, np.uint8)
    m = len(buf) // _CRC_CHUNKS
    state = np.uint32(0xFFFFFFFF)
    if m:
        rows = _crc_bytes(np.zeros(_CRC_CHUNKS, np.uint32),
                          buf[:m * _CRC_CHUNKS].reshape(_CRC_CHUNKS, m))
        cols = _crc_bytes(np.uint32(1) << np.arange(32, dtype=np.uint32),
                          np.zeros((32, m), np.uint8))      # Z_m's columns
        # Z_m x as four byte-table lookups: T[k][v] = Z_m (v << 8k)
        bits = (np.arange(256)[:, None] >> np.arange(8)) & 1          # (256, 8)
        zt = [np.bitwise_xor.reduce(np.where(bits == 1, cols[8 * k:8 * k + 8], 0), axis=1)
              for k in range(4)]
        s = int(state)
        for r in rows.tolist():
            s = (int(zt[0][s & 0xFF]) ^ int(zt[1][(s >> 8) & 0xFF])
                 ^ int(zt[2][(s >> 16) & 0xFF]) ^ int(zt[3][s >> 24]) ^ r)
        state = np.uint32(s)
    state = _crc_bytes(state[None], buf[None, m * _CRC_CHUNKS:])[0]
    return int(state) ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


class _PyRecordWriter:
    """TFRecord framing in pure Python: u64le length | u32le masked crc of
    the length bytes | payload | u32le masked crc of the payload. Byte-
    identical to TF's own writer; the python-loop CRC is the throughput
    limit (~1 MB/s/process), which the worker processes multiply."""

    def __init__(self, path: str):
        self._f = open(path, 'wb')

    def write(self, payload: bytes) -> None:
        header = struct.pack('<Q', len(payload))
        self._f.write(header)
        self._f.write(struct.pack('<I', _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack('<I', _masked_crc(payload)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- image loading / resize ----------------------------------------------------

def _load_encoded(path: str, resize: int, quality: int) -> bytes:
    """Image file -> encoded bytes for the record. Without resize the
    original file bytes pass through untouched; with resize the shorter
    side is scaled to `resize` px (the reference's `convert -resize
    "256x256^"`, README.md:186) and re-encoded as JPEG."""
    if not resize:
        with open(path, 'rb') as f:
            return f.read()
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert('RGB')
        w, h = im.size
        if min(w, h) != resize:
            if w <= h:
                nw, nh = resize, max(resize, round(h * resize / w))
            else:
                nw, nh = max(resize, round(w * resize / h)), resize
            im = im.resize((nw, nh), Image.LANCZOS)
        buf = io.BytesIO()
        im.save(buf, 'JPEG', quality=quality)
        return buf.getvalue()


# -- shard jobs -----------------------------------------------------------------

def write_shard(out_path: str, image_paths: Sequence[str],
                feature_key: str = _FEATURE_KEY, resize: int = 0,
                quality: int = 95) -> int:
    """Write one shard; returns the number of records written. Builds the
    offset index beside the shard (RecordsDataset reads it directly)."""
    n = 0
    with _PyRecordWriter(out_path) as w:
        for p in image_paths:
            w.write(serialize_example(_load_encoded(p, resize, quality),
                                      feature_key))
            n += 1
    from ..data.pipeline import tfrecord_index
    assert len(tfrecord_index(out_path)) == n, out_path
    return n


def _job(args):
    return write_shard(*args)


def resolve_images(spec: str) -> List[str]:
    """Directory (recursive), glob, or .txt list -> sorted image paths."""
    exts = ('.png', '.jpg', '.jpeg')
    if os.path.isdir(spec):
        out = []
        for root, _, names in os.walk(spec):
            out.extend(os.path.join(root, f) for f in names
                       if f.lower().endswith(exts))
        return sorted(out)
    if spec.endswith('.txt'):
        with open(spec) as f:
            return [ln.strip() for ln in f if ln.strip()]
    return sorted(glob.glob(spec, recursive=True))


def make_records(images_spec: str, out_dir: str, prefix: str = 'train',
                 num_per_shard: int = _NUM_PER_SHARD,
                 feature_key: str = _FEATURE_KEY, resize: int = 0,
                 quality: int = 95, workers: int = 0) -> List[str]:
    """Pack every image under `images_spec` into `<out_dir>/<prefix>-%05d
    .tfrecord` shards; returns the shard paths."""
    paths = resolve_images(images_spec)
    if not paths:
        raise ValueError(f'no images found for {images_spec!r}')
    os.makedirs(out_dir, exist_ok=True)
    chunks = [paths[i:i + num_per_shard]
              for i in range(0, len(paths), num_per_shard)]
    jobs = []
    for i, chunk in enumerate(chunks):
        shard = os.path.join(out_dir, f'{prefix}-{i:05d}.tfrecord')
        jobs.append((shard, chunk, feature_key, resize, quality))
    if workers > 1 and len(jobs) > 1:
        with get_context('spawn').Pool(workers) as pool:
            counts = pool.map(_job, jobs)
    else:
        counts = [_job(j) for j in jobs]
    total = sum(counts)
    print(f'{len(jobs)} shard(s), {total} records -> {out_dir}')
    return [j[0] for j in jobs]


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('images', help='image dir (recursive), glob, or .txt list')
    p.add_argument('-o', '--out_dir', required=True)
    p.add_argument('--prefix', default='train')
    p.add_argument('--num_per_shard', type=int, default=_NUM_PER_SHARD)
    p.add_argument('--feature_key', default=_FEATURE_KEY)
    p.add_argument('--resize', type=int, default=0,
                   help='shorter-side target px (0 = keep original bytes)')
    p.add_argument('--quality', type=int, default=95,
                   help='JPEG quality when --resize re-encodes')
    p.add_argument('--workers', type=int, default=os.cpu_count() or 1)
    p.add_argument('--pure_python', action='store_true',
                   help='accepted for the JAX tool\'s command line; the port '
                        'always frames in pure Python')
    a = p.parse_args(argv)
    make_records(a.images, a.out_dir, prefix=a.prefix,
                 num_per_shard=a.num_per_shard, feature_key=a.feature_key,
                 resize=a.resize, quality=a.quality, workers=a.workers)


if __name__ == '__main__':
    sys.exit(main())
