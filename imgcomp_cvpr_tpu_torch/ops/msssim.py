"""Multi-scale SSIM (batched, differentiable; port of
imgcomp_cvpr_tpu/ops/msssim.py).

- ``msssim_train`` is the training distortion (ref: ms_ssim.py:115-186):
  separable gaussian blur with VALID windows, and a 2-tap [1/2, 1/2]
  separable average (REFLECT pad (0, 1)) + stride-2 subsample between
  scales. ``cs``/``ssim`` are clamped at 1e-6 before the fractional powers.
- ``msssim_eval`` matches the NumPy validation oracle (ref:
  ms_ssim_np.py:51-110): a 2-D fspecial gaussian (made in float64, then
  cast), and a 2x2 box filter with 'symmetric' padding between scales.

Both take NHWC tensors in [0, max_val] and work in NCHW inside, in float32
(float64 inputs stay float64, for a referee run); every convolution is a
depthwise F.conv2d.

The window of a scale is min(11, H, W) wide. When that is even the train
variant still builds 2 * (size // 2) + 1 taps, one more than the image is
wide, and reflect-pads (total_pad, total_pad // 2) per axis before the blur
(ref: ms_ssim.py:16-29): a 160x160 crop reaches that at its fifth scale
(10x10).

The windows and the scale weights are uploaded once per (window, device,
dtype) and kept for the process (at most 11 windows a device): an upload
from host memory waits for the card, and a training step captured in a
CUDA graph may contain none, and reads them where they were captured.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from . import tf_compat
from ..parallel import mesh as mesh_lib

_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333], np.float32)


def _fspecial_gauss(size: int, sigma: float) -> np.ndarray:
    """2D gaussian matching MATLAB's fspecial (ref: ms_ssim_np.py:113-124)."""
    radius = size // 2
    offset = 0.0
    start, stop = -radius, radius + 1
    if size % 2 == 0:
        offset = 0.5
        stop -= 1
    x, y = np.mgrid[offset + start:stop, offset + start:stop]
    g = np.exp(-((x ** 2 + y ** 2) / (2.0 * sigma ** 2)))
    return (g / g.sum()).astype(np.float64)


def _gauss_kernel_1d(sigma: float, size: int) -> np.ndarray:
    n = size // 2
    x = np.arange(-n, n + 1, 1.0)
    g = np.exp(-x * x / (2 * sigma * sigma))
    return (g / np.sum(np.abs(g))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _gauss_1d_on(sigma: float, size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_gauss_kernel_1d(sigma, size)).to(device)


@functools.lru_cache(maxsize=None)
def _fspecial_gauss_on(size: int, sigma: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_fspecial_gauss(size, sigma).astype(np.float32)).to(device)


@functools.lru_cache(maxsize=None)
def _weights_on(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(_WEIGHTS).to(device, dtype)


def _blur_valid_separable(x: torch.Tensor, k: torch.Tensor, pad: int = 0) -> torch.Tensor:
    """Depthwise separable VALID blur over W then H of an NCHW tensor with
    the 1-D window ``k``."""
    if pad:
        x = tf_compat.reflect_pad_hw_nchw(x, ((pad, pad // 2), (pad, pad // 2)))
    y = tf_compat.depthwise_conv2d_valid_nchw(x, k[None, :])
    return tf_compat.depthwise_conv2d_valid_nchw(y, k[:, None])


def _blur_valid_2d(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return tf_compat.depthwise_conv2d_valid_nchw(x, k)


def _ssim_for_scale(img1, img2, blur: Callable, max_val, k1=0.01, k2=0.03):
    """SSIM mean + contrast sensitivity for one scale (ref: ms_ssim.py:81-112)."""
    mu1 = blur(img1)
    mu2 = blur(img2)
    sigma11 = blur(img1 * img1) - mu1 * mu1
    sigma22 = blur(img2 * img2) - mu2 * mu2
    sigma12 = blur(img1 * img2) - mu1 * mu2
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    v1 = 2.0 * sigma12 + c2
    v2 = sigma11 + sigma22 + c2
    # means over the global batch under data parallelism (parallel/mesh.py)
    ssim = mesh_lib.batch_mean(((2.0 * mu1 * mu2 + c1) * v1) / ((mu1 * mu1 + mu2 * mu2 + c1) * v2))
    cs = mesh_lib.batch_mean(v1 / v2)
    return ssim, cs


def _downsample_train(x: torch.Tensor) -> torch.Tensor:
    """2-tap [.5, .5] separable average with REFLECT pad (0, 1), then stride
    2 (ref: ms_ssim.py:46-64,179-181)."""
    x = tf_compat.reflect_pad_hw_nchw(x, ((0, 1), (0, 1)))
    k = torch.full((2,), 0.5, dtype=x.dtype, device=x.device)
    y = tf_compat.depthwise_conv2d_valid_nchw(x, k[None, :])
    y = tf_compat.depthwise_conv2d_valid_nchw(y, k[:, None])
    return y[:, :, ::2, ::2]


def _downsample_eval(x: torch.Tensor) -> torch.Tensor:
    """2x2 box filter with scipy.ndimage 'reflect' alignment (numpy
    'symmetric': the edge row and column repeated after the image), then
    stride 2 (ref: ms_ssim_np.py:96,106-108). F.pad has no symmetric mode,
    so the flipped edge is concatenated."""
    x = torch.cat([x, x[:, :, -1:]], dim=2)
    x = torch.cat([x, x[:, :, :, -1:]], dim=3)
    k = torch.full((2, 2), 0.25, dtype=x.dtype, device=x.device)
    return tf_compat.depthwise_conv2d_valid_nchw(x, k)[:, :, ::2, ::2]


def _msssim(img1: torch.Tensor, img2: torch.Tensor, max_val: float, variant: str
            ) -> torch.Tensor:
    if img1.ndim != 4 or img1.shape != img2.shape:
        raise ValueError(f'expected two equal NHWC shapes, got {tuple(img1.shape)} '
                         f'and {tuple(img2.shape)}')
    dtype = torch.float64 if img1.dtype == torch.float64 else torch.float32
    im1 = img1.to(dtype).permute(0, 3, 1, 2)
    im2 = img2.to(dtype).permute(0, 3, 1, 2)
    levels = _WEIGHTS.size
    weights = _weights_on(im1.device, dtype)
    mssim, mcs = [], []
    for level in range(levels):
        h, w = im1.shape[2], im1.shape[3]
        size = min(11, h, w)
        sigma = size * 1.5 / 11
        if variant == 'train':
            k1d = _gauss_1d_on(sigma, size, im1.device)
            total_pad = max(k1d.shape[0] - w, 0)

            def blur(x, k1d=k1d, total_pad=total_pad):
                return _blur_valid_separable(x, k1d, total_pad)
        else:
            k2d = _fspecial_gauss_on(size, sigma, im1.device)

            def blur(x, k2d=k2d):
                return _blur_valid_2d(x, k2d)
        ssim, cs = _ssim_for_scale(im1, im2, blur, max_val)
        mssim.append(ssim)
        mcs.append(cs)
        if level < levels - 1:
            down = _downsample_train if variant == 'train' else _downsample_eval
            im1, im2 = down(im1), down(im2)
    mcs_t = torch.stack(mcs)
    mssim_t = torch.stack(mssim)
    if variant == 'train':
        # cs/ssim can go negative for uncorrelated images (early training);
        # negative ** fractional weight is NaN. Clamped in the training
        # loss only.
        mcs_t = torch.clamp(mcs_t, min=1e-6)
        mssim_t = torch.clamp(mssim_t, min=1e-6)
    prod = _ProdOfPositives.apply if variant == 'train' else torch.prod
    return (prod(mcs_t[:levels - 1] ** weights[:levels - 1]) *
            (mssim_t[levels - 1] ** weights[levels - 1]))


class _ProdOfPositives(torch.autograd.Function):
    """torch.prod of a vector with no zero entry, with the gradient torch
    gives it then, grad * (prod / x), without torch's test for zeros: that
    test (a nonzero()) waits for the card, which a training step captured
    in a CUDA graph may not do. The training variant's factors are
    cs ** w with cs clamped at 1e-6 and 0 < w < 1, never 0."""

    @staticmethod
    def forward(ctx, x):
        out = torch.prod(x)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return grad * (out / x)


def msssim_train(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 255.0
                 ) -> torch.Tensor:
    """Differentiable MS-SSIM used as the training distortion."""
    return _msssim(img1, img2, max_val, 'train')


def msssim_eval(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 255.0
                ) -> torch.Tensor:
    """MS-SSIM matching the NumPy eval oracle."""
    return _msssim(img1, img2, max_val, 'eval')
