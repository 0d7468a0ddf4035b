"""The autoencoder's eval-mode conv epilogue: BatchNorm with running
statistics, the cast to the towers' dtype, ReLU and up to two residual adds,
as one CUDA kernel (csrc/ae_epilogue.cu) and its plain version.

``epilogue`` launches the kernel for a CUDA tensor and runs
``epilogue_plain``, the eager chain, only for a CPU tensor. The kernel
reads the conv output through its strides (a transposed conv's crop is a
view) and writes a channels-last output; on the same conv output both give
the same bits. The kernel does no autograd: a tensor that needs grad raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_P, _I, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P, _P, _I, _P, _P, _P, _P)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def epilogue_plain(y: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                   bias: torch.Tensor, act: bool,
                   residuals: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """The eager chain on the conv output y (N, C, H, W): BatchNorm in
    float32 (mean, mul = rsqrt(var + eps) * scale and bias are (C,)
    float32), the cast back to y's dtype, ReLU where ``act``, then each
    residual added in y's dtype, in order."""
    dt = y.dtype
    out = ((y.float() - mean[:, None, None]) * mul[:, None, None]
           + bias[:, None, None]).to(dt)
    if act:
        out = torch.relu(out)
    for r in residuals:
        out = out + r.to(dt)
    return out


def epilogue(y: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
             act: bool, residuals: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """``epilogue_plain``'s result; on a CUDA tensor one kernel launch that
    returns a channels-last tensor of y's dtype (float32 or bfloat16)."""
    if y.device.type == 'cpu':
        return epilogue_plain(y, mean, mul, bias, act, residuals)
    code = _DTYPE_CODES.get(y.dtype)
    if code is None or y.dim() != 4 or len(residuals) > 2:
        raise ValueError(f'ae_epilogue takes a 4-d float32 or bfloat16 y and at most two '
                         f'residuals, got {y.dtype} {tuple(y.shape)}, {len(residuals)}')
    n, c, h, w = y.shape
    if y.numel() >= 2 ** 31:
        raise ValueError(f'ae_epilogue indexes in 32 bits: {tuple(y.shape)} has 2^31 or more '
                         f'elements; run the towers on fewer images at once')
    for t in (mean, mul, bias):
        if t.dtype != torch.float32 or t.shape != (c,) or t.device != y.device \
                or not t.is_contiguous():
            raise ValueError(f'ae_epilogue: BatchNorm operands must be contiguous float32 '
                             f'({c},) on {y.device}, got {t.dtype} {tuple(t.shape)} on {t.device}')
    rs = [r.contiguous(memory_format=torch.channels_last) for r in residuals]
    for r in rs:
        if r.dtype != y.dtype or r.shape != y.shape or r.device != y.device:
            raise ValueError(f'ae_epilogue: residual {r.dtype} {tuple(r.shape)} on {r.device}, '
                             f'y {y.dtype} {tuple(y.shape)} on {y.device}')
    if any(t.requires_grad for t in (y, mean, mul, bias, *rs)):
        raise RuntimeError('ae_epilogue has no backward: a tensor that needs grad reached '
                           'the eval-mode epilogue on the card')
    out = torch.empty((n, c, h, w), dtype=y.dtype, device=y.device,
                      memory_format=torch.channels_last)
    r0 = rs[0].data_ptr() if rs else None
    r1 = rs[1].data_ptr() if len(rs) > 1 else None
    fn = build.entry('ae_epilogue', 'ae_epilogue', _ARGTYPES)
    with build.on_device(y.device):
        err = fn(y.data_ptr(), code, n, c, h, w, *y.stride(), mean.data_ptr(), mul.data_ptr(),
                 bias.data_ptr(), int(act), r0, r1, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    build.LAUNCHES['ae_epilogue'] += 1
    build.check(err, 'ae_epilogue')
    return out
