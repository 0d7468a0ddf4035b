"""Distortion metrics: MSE / PSNR per image (port of
imgcomp_cvpr_tpu/ops/metrics.py; ref: train.py:402-426)."""

from __future__ import annotations

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
