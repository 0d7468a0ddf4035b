"""Soft-to-hard scalar quantization against learned centers.

Port of imgcomp_cvpr_tpu/models/quantizer.py (ref: quantizer.py:37-95):
qsoft = softmax(-sigma (x - c)^2) . c, qhard / symbols = the nearest center,
qbar = qsoft + (qhard - qsoft).detach(). The per-element work goes
through ops/kernels/quantize.py::QuantizeFn: CUDA kernel 1 forward and
kernel 7 backward on a card, their plain versions on the CPU. The
straight-through arithmetic stays here, so qbar's cotangent reaches the
backward through qsoft.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..ops.kernels import quantize as quantize_kernel


class QuantizerOutput(NamedTuple):
    qbar: torch.Tensor     # straight-through soft/hard mix, same shape as x
    qsoft: torch.Tensor    # soft assignment expectation
    qhard: torch.Tensor    # nearest center
    symbols: torch.Tensor  # int32 indices into centers


def quantize(x: torch.Tensor, centers: torch.Tensor, sigma: float = 1.0
             ) -> QuantizerOutput:
    if centers.ndim != 1:
        raise ValueError(f'centers must be 1-D, got {tuple(centers.shape)}')
    qsoft, qhard, symbols = quantize_kernel.QuantizeFn.apply(x, centers, sigma)
    qbar = qsoft + (qhard - qsoft).detach()
    return QuantizerOutput(qbar, qsoft, qhard, symbols)


def init_centers(gen: torch.Generator, num_centers: int,
                 initial_range: Sequence[float]) -> torch.Tensor:
    """Uniform init in ``centers_initial_range`` (ref: quantizer.py:28-31)."""
    lo, hi = map(float, initial_range)
    return lo + (hi - lo) * torch.rand(num_centers, generator=gen)


def centers_regularization(centers: torch.Tensor, factor: float) -> torch.Tensor:
    """factor * l2_loss(centers) == factor * sum(c^2)/2 (ref: quantizer.py:18-24)."""
    if not factor:
        return centers.new_zeros(())
    return factor * 0.5 * torch.sum(torch.square(centers))
