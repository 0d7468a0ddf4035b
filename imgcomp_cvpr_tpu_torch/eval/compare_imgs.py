"""Image comparison metrics for files or arrays (own copy of
imgcomp_cvpr_tpu/eval/compare_imgs.py; ref: compare_imgs.py:58-76):
single-scale SSIM (Wang 2004 conventions), MS-SSIM (the NumPy oracle) and
PSNR, on the host.

    python -m imgcomp_cvpr_tpu_torch.eval.compare_imgs a.png b.png
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..ops import metrics as metrics_lib
from ..ops import msssim_np


def ssim(img1: np.ndarray, img2: np.ndarray, max_val: float = 255.0) -> float:
    """Mean single-scale SSIM over channels (11x11 gaussian window)."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if img1.ndim == 2:
        img1 = img1[..., None]
        img2 = img2[..., None]
    s, _ = msssim_np._ssim_for_scale(img1[None], img2[None], max_val=max_val)
    return float(s)


def msssim(img1: np.ndarray, img2: np.ndarray, max_val: float = 255.0) -> float:
    img1 = np.asarray(img1)
    img2 = np.asarray(img2)
    if img1.ndim == 3:
        img1 = img1[None]
        img2 = img2[None]
    return msssim_np.msssim(img1, img2, max_val=max_val)


def psnr(img1: np.ndarray, img2: np.ndarray, max_val: float = 255.0) -> float:
    return metrics_lib.psnr_np(img1, img2, max_val=max_val)


def compare(img1, img2, calc_ssim: bool = True, calc_msssim: bool = True,
            calc_psnr: bool = True
            ) -> Tuple[Optional[float], Optional[float], Optional[float]]:
    """img1/img2: HWC uint8 arrays or file paths. Returns (ssim, msssim, psnr)
    with None for disabled metrics (ref: compare_imgs.py:58-76)."""
    img1 = _load(img1)
    img2 = _load(img2)
    if img1.shape != img2.shape:
        raise ValueError(f'shapes differ: {img1.shape} vs {img2.shape}')
    return (ssim(img1, img2) if calc_ssim else None,
            msssim(img1, img2) if calc_msssim else None,
            psnr(img1, img2) if calc_psnr else None)


def _load(img) -> np.ndarray:
    if isinstance(img, str):
        from PIL import Image
        with Image.open(img) as im:
            return np.asarray(im.convert('RGB'), np.uint8)
    return np.asarray(img)


def main():
    """CLI: compare two image files (ref: compare_imgs.py main)."""
    import argparse
    import time
    p = argparse.ArgumentParser()
    p.add_argument('img1')
    p.add_argument('img2')
    p.add_argument('--timing', action='store_true',
                   help='Also print per-metric wall time.')
    flags = p.parse_args()
    a, b = _load(flags.img1), _load(flags.img2)
    for name, fn in [('ssim', ssim), ('ms-ssim', msssim), ('psnr', psnr)]:
        t0 = time.time()
        v = fn(a, b)
        suffix = f'  ({time.time() - t0:.3f}s)' if flags.timing else ''
        print(f'{name}: {v:.6f}{suffix}')


if __name__ == '__main__':
    main()
