"""NumPy MS-SSIM, the validation oracle (own copy of
imgcomp_cvpr_tpu/ops/msssim_np.py).

The classic Wang-2003 multi-scale SSIM with the reference's eval conventions
(ref: ms_ssim_np.py:51-110, itself the TensorFlow-models script): float64,
11x11 'fspecial' gaussian window, VALID fftconvolve, 2x2 box downsample via
scipy.ndimage.convolve with 'reflect' boundaries, per-scale weights [0.0448,
0.2856, 0.3001, 0.2363, 0.1333]. Host side: eval/compare_imgs.py and the
baseline-codec curves use it; ops/msssim.py::msssim_eval is its torch twin.
"""

from __future__ import annotations

import numpy as np
from scipy import signal
from scipy import ndimage

_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333])


def _fspecial_gauss(size: int, sigma: float) -> np.ndarray:
    radius = size // 2
    offset = 0.0
    start, stop = -radius, radius + 1
    if size % 2 == 0:
        offset = 0.5
        stop -= 1
    x, y = np.mgrid[offset + start:stop, offset + start:stop]
    g = np.exp(-((x ** 2 + y ** 2) / (2.0 * sigma ** 2)))
    return g / g.sum()


def _ssim_for_scale(img1: np.ndarray, img2: np.ndarray, max_val: float = 255,
                    filter_size: int = 11, filter_sigma: float = 1.5,
                    k1: float = 0.01, k2: float = 0.03):
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    _, height, width, _ = img1.shape
    size = min(filter_size, height, width)
    sigma = size * filter_sigma / filter_size if filter_size else 0

    if filter_size:
        window = np.reshape(_fspecial_gauss(size, sigma), (1, size, size, 1))
        mu1 = signal.fftconvolve(img1, window, mode='valid')
        mu2 = signal.fftconvolve(img2, window, mode='valid')
        sigma11 = signal.fftconvolve(img1 * img1, window, mode='valid')
        sigma22 = signal.fftconvolve(img2 * img2, window, mode='valid')
        sigma12 = signal.fftconvolve(img1 * img2, window, mode='valid')
    else:
        mu1, mu2 = img1, img2
        sigma11, sigma22, sigma12 = img1 * img1, img2 * img2, img1 * img2

    sigma11 = sigma11 - mu1 * mu1
    sigma22 = sigma22 - mu2 * mu2
    sigma12 = sigma12 - mu1 * mu2
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    v1 = 2.0 * sigma12 + c2
    v2 = sigma11 + sigma22 + c2
    ssim = np.mean(((2.0 * mu1 * mu2 + c1) * v1) / ((mu1 * mu1 + mu2 * mu2 + c1) * v2))
    cs = np.mean(v1 / v2)
    return ssim, cs


def msssim(img1: np.ndarray, img2: np.ndarray, max_val: float = 255) -> float:
    """img1, img2: (N, H, W, C) arrays in [0, max_val]."""
    if img1.shape != img2.shape:
        raise ValueError(f'shape mismatch: {img1.shape} vs {img2.shape}')
    if img1.ndim != 4:
        raise ValueError(f'expected NHWC, got {img1.shape}')
    levels = _WEIGHTS.size
    box = np.ones((1, 2, 2, 1)) / 4.0
    im1 = img1.astype(np.float64)
    im2 = img2.astype(np.float64)
    mssim = []
    mcs = []
    for _ in range(levels):
        ssim, cs = _ssim_for_scale(im1, im2, max_val=max_val)
        mssim.append(ssim)
        mcs.append(cs)
        im1, im2 = [ndimage.convolve(im, box, mode='reflect')[:, ::2, ::2, :]
                    for im in (im1, im2)]
    mssim = np.array(mssim)
    mcs = np.array(mcs)
    return float(np.prod(mcs[:levels - 1] ** _WEIGHTS[:levels - 1]) *
                 (mssim[levels - 1] ** _WEIGHTS[levels - 1]))
