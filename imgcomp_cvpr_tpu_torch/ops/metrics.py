"""Distortion metrics: MSE / PSNR per image (port of
imgcomp_cvpr_tpu/ops/metrics.py; ref: train.py:402-426, val.py:227-237)."""

from __future__ import annotations

import numpy as np
import torch


def mse_per_image(inp: torch.Tensor, otp: torch.Tensor, cast_to_int: bool) -> torch.Tensor:
    """(N, H, W, C) -> (N,). With cast_to_int both sides go through int32
    first (truncation toward zero) to measure the quantized-pixel error; no
    gradient passes the cast."""
    if cast_to_int:
        inp = inp.to(torch.int32)
        otp = otp.to(torch.int32)
    se = torch.square((otp - inp).to(torch.float32))
    return se.mean((1, 2, 3))


def psnr_per_image(inp: torch.Tensor, otp: torch.Tensor, cast_to_int: bool) -> torch.Tensor:
    """Identical images give inf."""
    mse = mse_per_image(inp, otp, cast_to_int)
    psnr = 10.0 * torch.log10(255.0 * 255.0 / torch.clamp(mse, min=1e-20))
    return torch.where(mse == 0.0, torch.full_like(mse, float('inf')), psnr)


def psnr_np(img1, img2, max_val: float = 255.0) -> float:
    """Host-side PSNR of two arrays (skimage.compare_psnr semantics, ref:
    val.py:227-237). Identical images give inf, without numpy's
    divide-by-zero warning."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0.0:
        return float('inf')
    return float(10.0 * np.log10(max_val * max_val / mse))
