"""Baseline-codec rate-distortion tooling (own copy of
imgcomp_cvpr_tpu/eval/other_codecs.py; ref: other_codecs.py).

Measures JPEG / WebP / JPEG2000 / BPG R-D curves over quality grids and
writes per-image ``<img>_out.csv`` files with rows ``q,bpp,ssim,msssim,psnr``,
the format the codec-distance and plotting code reads (ref:
other_codecs.py:107-119). JPEG, WebP and JPEG2000 go through Pillow;
JPEG2000 uses the kakadu binaries (``kdu_compress`` / ``kdu_expand``,
$KDU_COMPRESS / $KDU_EXPAND) where they are installed, and BPG shells out to
``bpgenc`` / ``bpgdec``, raising a clear error where they are missing
(``kakadu_available``, ``bpg_available``). Includes the target-bpp binary
search (ref: other_codecs.py:491-527).

    python -m imgcomp_cvpr_tpu_torch.eval.other_codecs imgs/ out_jp_x jp
"""

from __future__ import annotations

import glob
import io
import os
import shutil
import subprocess
import tempfile
from typing import Callable, Iterator, List, Sequence, Tuple

import numpy as np

from . import compare_imgs

SUPPORTED_METRICS = ('psnr', 'ssim', 'ms-ssim')

DEFAULT_GRIDS = {
    'jp': list(range(5, 96, 5)),          # JPEG quality
    'webp': list(range(5, 96, 5)),        # WebP quality
    'jp2k': [0.1, 0.2, 0.3, 0.4, 0.5, 0.7, 0.9, 1.1, 1.4, 1.8],  # target bpp
    'bpg': list(range(20, 48, 2)),        # BPG q (lower = better)
}


# ---------------------------------------------------------------------------
# Individual codecs: compress -> (decoded HWC uint8, bpp)
# ---------------------------------------------------------------------------

def _load_rgb(p: str) -> np.ndarray:
    from PIL import Image
    with Image.open(p) as im:
        return np.asarray(im.convert('RGB'), np.uint8)


def _num_pixels(img: np.ndarray) -> int:
    return img.shape[0] * img.shape[1]


def _pil_roundtrip(img: np.ndarray, fmt: str, **save_kwargs
                   ) -> Tuple[np.ndarray, float]:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, **save_kwargs)
    nbytes = buf.tell()
    buf.seek(0)
    with Image.open(buf) as im:
        out = np.asarray(im.convert('RGB'), np.uint8)
    return out, nbytes * 8 / _num_pixels(img)


def jpeg_content_length(data: bytes) -> int:
    """Bytes of JPEG entropy-coded content: everything between the
    start-of-scan marker (FF DA) and the trailing EOI marker. Same
    accounting as the reference's header scan (ref: other_codecs.py:244-263)
    — JPEG bpp is computed from content, not file size."""
    sos = data.find(b'\xff\xda')
    if sos < 0:
        raise ValueError('no start-of-scan marker: not a JPEG?')
    # size minus the index of the DA byte minus the 2-byte EOI — the
    # reference's exact accounting (it also anchors on the FIRST FF DA,
    # ref other_codecs.py:258-263).
    return len(data) - (sos + 1) - 2


def jp_compress(img: np.ndarray, quality: int) -> Tuple[np.ndarray, float]:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, 'JPEG', quality=int(quality))
    data = buf.getvalue()
    buf.seek(0)
    with Image.open(buf) as im:
        out = np.asarray(im.convert('RGB'), np.uint8)
    return out, jpeg_content_length(data) * 8 / _num_pixels(img)


def webp_compress(img: np.ndarray, quality: int) -> Tuple[np.ndarray, float]:
    return _pil_roundtrip(img, 'WEBP', quality=int(quality), method=4)


KDU_COMPRESS = os.environ.get('KDU_COMPRESS', 'kdu_compress')
KDU_EXPAND = os.environ.get('KDU_EXPAND', 'kdu_expand')


def kakadu_available() -> bool:
    return (shutil.which(KDU_COMPRESS) is not None
            and shutil.which(KDU_EXPAND) is not None)


def jp2k_compress_kakadu(img: np.ndarray, target_bpp: float
                         ) -> Tuple[np.ndarray, float]:
    """JPEG2000 via the kakadu binaries when installed — the reference's
    backend (ref: other_codecs.py:190-199); actual bpp parsed from
    kdu_compress's codestream report."""
    import re
    from PIL import Image
    with tempfile.TemporaryDirectory() as d:
        in_p = os.path.join(d, 'in.bmp')   # kdu wants bmp/tif/pgm/ppm
        j2_p = os.path.join(d, 'out.jp2')
        out_p = os.path.join(d, 'out.bmp')
        Image.fromarray(img).save(in_p)
        out = subprocess.check_output(
            [KDU_COMPRESS, '-i', in_p, '-o', j2_p,
             '-rate', str(float(target_bpp)), '-no_weights']).decode()
        m = re.search(r'Compressed bytes \(excludes codestream headers\)'
                      r' = .*=\s(.*)\sbpp', out)
        if m is None:
            raise ValueError(
                f'could not parse kdu_compress bpp report:\n{out[-500:]}')
        actual_bpp = float(m.group(1))
        subprocess.check_call([KDU_EXPAND, '-i', j2_p, '-o', out_p])
        decoded = _load_rgb(out_p)
    return decoded, actual_bpp


def jp2k_compress(img: np.ndarray, target_bpp: float) -> Tuple[np.ndarray, float]:
    """JPEG2000 at a target rate: kakadu when installed, else Pillow
    (``quality_layers`` with ``quality_mode='rates'`` takes a compression
    *ratio*; 24-bit RGB at ratio r gives 24/r bpp)."""
    if kakadu_available():
        return jp2k_compress_kakadu(img, target_bpp)
    ratio = 24.0 / float(target_bpp)
    return _pil_roundtrip(img, 'JPEG2000', quality_mode='rates',
                          quality_layers=[ratio], irreversible=True)


class BPGInfo:
    """Parsed BPG container header (format: magic, 2 flag bytes, then
    ue7-coded width / height / picture_data_length; a zero length means
    the picture runs to EOF). BPG bpp is computed from the PICTURE payload,
    not the file size — the container header would bias small images
    (ref behavior: other_codecs.py:422-463)."""

    MAGIC = bytes.fromhex('425047fb')

    def __init__(self, data: bytes):
        if data[:4] != self.MAGIC:
            raise ValueError('not a BPG bitstream')
        pos = 6  # magic + pixel_format/alpha byte + bit_depth/color byte
        self.width, pos = _take_ue7(data, pos)
        self.height, pos = _take_ue7(data, pos)
        pic_len, pos = _take_ue7(data, pos)
        self.picture_bytes = pic_len if pic_len else len(data) - pos
        self.bpp = self.picture_bytes * 8 / float(self.width * self.height)


def _take_ue7(data: bytes, pos: int) -> Tuple[int, int]:
    """Decode one ue7 varint (7 value bits per byte, MSB = continuation)
    starting at pos; returns (value, next_pos)."""
    value = 0
    while True:
        byte = data[pos]
        pos += 1
        value = (value << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return value, pos


def bpg_bpp_from_file(bpg_p: str) -> float:
    with open(bpg_p, 'rb') as f:
        return BPGInfo(f.read()).bpp


def bpg_available() -> bool:
    return shutil.which('bpgenc') is not None and shutil.which('bpgdec') is not None


def bpg_compress(img: np.ndarray, q: int) -> Tuple[np.ndarray, float]:
    """Shell out to bpgenc/bpgdec (ref: other_codecs.py:350-359)."""
    if not bpg_available():
        raise RuntimeError('bpgenc/bpgdec not installed; BPG curves unavailable')
    from PIL import Image
    with tempfile.TemporaryDirectory() as d:
        in_p = os.path.join(d, 'in.png')
        bpg_p = os.path.join(d, 'out.bpg')
        out_p = os.path.join(d, 'out.png')
        Image.fromarray(img).save(in_p)
        subprocess.check_call(['bpgenc', '-q', str(int(q)), '-o', bpg_p, in_p])
        bpp = bpg_bpp_from_file(bpg_p)   # picture payload, not file size
        subprocess.check_call(['bpgdec', '-o', out_p, bpg_p])
        out = _load_rgb(out_p)
    return out, bpp


CODEC_FNS: dict = {
    'jp': jp_compress,
    'webp': webp_compress,
    'jp2k': jp2k_compress,
    'bpg': bpg_compress,
}


# ---------------------------------------------------------------------------
# Curves + measures files
# ---------------------------------------------------------------------------

def measures_file_p(out_dir: str, img_name: str) -> str:
    return os.path.join(out_dir, f'{img_name}_out.csv')


def all_measures_file_ps(out_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(out_dir, '*_out.csv')))


def read_measures(csv_p: str, metric: str) -> Iterator[Tuple[float, float]]:
    if metric not in SUPPORTED_METRICS:
        raise ValueError(f'unknown metric {metric!r}')
    with open(csv_p) as f:
        for line in f:
            if not line.strip():
                continue
            _, bpp, ssim_v, msssim_v, psnr_v = line.strip().split(',')
            yield (float(bpp),
                   float({'ssim': ssim_v, 'ms-ssim': msssim_v,
                          'psnr': psnr_v}[metric]))


def measure_over_grid(img: np.ndarray, codec: str, grid: Sequence[float],
                      fout) -> None:
    fn: Callable = CODEC_FNS[codec]
    for q in grid:
        out, bpp = fn(img, q)
        s, ms, ps = compare_imgs.compare(img, out)
        fout.write(','.join(f'{v:.3f}' for v in (q, bpp, s, ms, ps)) + '\n')


def _get_image_paths(root_dir: str) -> List[str]:
    if '*' in root_dir:
        return sorted(glob.glob(root_dir))
    if os.path.splitext(root_dir)[1]:
        return [root_dir]
    return sorted(glob.glob(os.path.join(root_dir, '*.png')))


def create_curves_for_images(root_dir: str, out_dir: str,
                             grid: Sequence[float], mode: str) -> None:
    """Per image in root_dir, sweep codec ``mode`` over ``grid`` and write
    ``<out_dir>/<img>_out.csv`` (skips images already measured,
    ref: other_codecs.py:71-96)."""
    os.makedirs(out_dir, exist_ok=True)
    img_ps = _get_image_paths(root_dir)
    if not img_ps:
        raise ValueError(f'no images in {root_dir}')
    for img_p in img_ps:
        img_name = os.path.splitext(os.path.basename(img_p))[0]
        mf = measures_file_p(out_dir, img_name)
        if os.path.exists(mf):
            continue
        img = _load_rgb(img_p)
        with open(mf, 'w') as f:
            measure_over_grid(img, mode, grid, f)
        print(f'{img_name}: done')


def binary_search(eval_fn: Callable[[float], float], target: float,
                  lo: float, hi: float, eps: float = 1e-3,
                  max_iter: int = 30) -> float:
    """Find q in [lo, hi] with eval_fn(q) ~ target; eval_fn monotone
    increasing in q (ref: other_codecs.py:491-527)."""
    for _ in range(max_iter):
        mid = (lo + hi) / 2
        v = eval_fn(mid)
        if abs(v - target) < eps:
            return mid
        if v < target:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def compress_to_target_bpp(img: np.ndarray, codec: str, target_bpp: float,
                           q_lo: float = 1, q_hi: float = 100
                           ) -> Tuple[np.ndarray, float, float]:
    """(decoded, actual_bpp, q) hitting target_bpp via binary search."""
    fn = CODEC_FNS[codec]
    sign = -1.0 if codec == 'bpg' else 1.0  # BPG: lower q = higher bpp

    def bpp_of(q):
        return sign * fn(img, q)[1]

    q = binary_search(bpp_of, sign * target_bpp, q_lo, q_hi)
    out, bpp = fn(img, q)
    return out, bpp, q


def main():
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument('images', help='dir of PNGs / glob / single image')
    p.add_argument('out_dir')
    p.add_argument('mode', choices=sorted(CODEC_FNS))
    p.add_argument('--grid', type=float, nargs='+', default=None)
    flags = p.parse_args()
    grid = flags.grid or DEFAULT_GRIDS[flags.mode]
    create_curves_for_images(flags.images, flags.out_dir, grid, flags.mode)


if __name__ == '__main__':
    main()
