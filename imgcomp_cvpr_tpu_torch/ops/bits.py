"""Bit-cost to bits-per-pixel conversion (port of imgcomp_cvpr_tpu/ops/bits.py)."""

import torch

from ..parallel import mesh as mesh_lib


def num_pixels_in_input_batch(input_nhwc: torch.Tensor) -> int:
    if input_nhwc.ndim != 4 or input_nhwc.shape[-1] != 3:
        raise ValueError(f'expected (N, H, W, 3), got {tuple(input_nhwc.shape)}')
    return input_nhwc.shape[0] * input_nhwc.shape[1] * input_nhwc.shape[2]


def bitcost_to_bpp(bit_cost: torch.Tensor, input_nhwc: torch.Tensor) -> torch.Tensor:
    """sum(bit_cost) / num_pixels. bit_cost: (N, h, w, C); input: (N, H, W, 3);
    over the global batch under data parallelism (parallel/mesh.py)."""
    if bit_cost.ndim != 4:
        raise ValueError(f'expected (N, h, w, C), got {tuple(bit_cost.shape)}')
    return (mesh_lib.batch_sum(bit_cost)
            / float(num_pixels_in_input_batch(input_nhwc) * mesh_lib.world_size()))
