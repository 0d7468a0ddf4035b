"""Rate-distortion loss composition (port of
imgcomp_cvpr_tpu/training/losses.py; ref: train.py:303-336).

total = d_loss_scaled + beta * max(H_soft - H_target, 0) + regularizers
with H_soft = (H_mask + H_real) / 2, H_mask = mean(bc * heatmap),
H_real = mean(bc). Regularizers: L2 on every conv kernel of encoder /
decoder / context model (slim's l2_regularizer = factor * sum(w^2)/2) and
on the quantizer centers.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..models.autoencoder import SlimConv
from ..models.probclass import MaskedConv3D
from ..parallel import mesh as mesh_lib


def l2_of_conv_kernels(module: nn.Module) -> torch.Tensor:
    """Sum of l2_loss (= sum(w^2)/2) over the conv kernels under ``module``:
    the ``weight`` of every SlimConv and MaskedConv3D (the raw 3-D weight,
    not weight * mask). BatchNorm scale/bias, biases and centers are not
    conv kernels."""
    total = None
    for m in module.modules():
        if isinstance(m, (SlimConv, MaskedConv3D)):
            term = 0.5 * torch.sum(torch.square(m.weight))
            total = term if total is None else total + term
    if total is None:
        raise ValueError('no conv kernels under the module')
    return total


def rate_loss(bc: torch.Tensor, heatmap: Optional[torch.Tensor], H_target: float,
              beta: float) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    H_real = mesh_lib.batch_mean(bc)
    H_mask = mesh_lib.batch_mean(bc * heatmap) if heatmap is not None else H_real
    H_soft = 0.5 * (H_mask + H_real)
    pc_loss = beta * torch.clamp(H_soft - H_target, min=0.0)
    return pc_loss, {'H_real': H_real, 'H_mask': H_mask, 'H_soft': H_soft,
                     'pc_loss': pc_loss}


def total_loss(ae_config, pc_config, d_loss_scaled: torch.Tensor, bc: torch.Tensor,
               heatmap: Optional[torch.Tensor], ae: nn.Module, pc: nn.Module,
               centers: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    pc_loss, comps = rate_loss(bc, heatmap, ae_config.H_target, ae_config.beta)

    reg_ae = ae_config.regularization_factor * l2_of_conv_kernels(ae)
    reg_centers = (ae_config.regularization_factor_centers or 0.0) * \
        0.5 * torch.sum(torch.square(centers))
    pc_factor = pc_config.regularization_factor
    reg_pc = pc_factor * l2_of_conv_kernels(pc) if pc_factor else bc.new_zeros(())

    total = d_loss_scaled + pc_loss + reg_ae + reg_centers + reg_pc
    comps.update({'d_loss_scaled': d_loss_scaled, 'reg_ae': reg_ae,
                  'reg_centers': reg_centers, 'reg_pc': reg_pc,
                  'total_loss': total})
    return total, comps
