"""Distortion measures and the scaled distortion-to-minimize (port of
imgcomp_cvpr_tpu/training/distortions.py; ref: train.py:352-431).

- mse / psnr go through an int cast whenever they are not the quantity
  being optimized (pixels are quantized in the real world).
- d_loss_scaled: mse | K_psnr - psnr | K_ms_ssim * (1 - ms_ssim).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops import metrics, msssim
from ..parallel import mesh as mesh_lib


def compute(ae_config, x: torch.Tensor, x_out: torch.Tensor, is_training: bool
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x, x_out: (N, H, W, 3) float in [0, 255]. Returns (d_loss_scaled, comps)."""
    minimize_for = ae_config.distortion_to_minimize
    if minimize_for not in ('mse', 'psnr', 'ms_ssim'):
        raise ValueError(f'invalid distortion_to_minimize {minimize_for!r}')

    cast_for_psnr = (not is_training) or minimize_for != 'psnr'
    cast_for_mse = (not is_training) or minimize_for != 'mse'
    mse = mesh_lib.batch_mean(metrics.mse_per_image(x, x_out, cast_for_mse))
    psnr = mesh_lib.batch_mean(metrics.psnr_per_image(x, x_out, cast_for_psnr))
    comps = {'mse': mse, 'psnr': psnr}

    if minimize_for == 'mse':
        d_loss = mse
    elif minimize_for == 'psnr':
        d_loss = ae_config.K_psnr - psnr
    else:
        comps['ms_ssim'] = msssim.msssim_train(x, x_out)
        d_loss = ae_config.K_ms_ssim * (1.0 - comps['ms_ssim'])
    return d_loss, comps
