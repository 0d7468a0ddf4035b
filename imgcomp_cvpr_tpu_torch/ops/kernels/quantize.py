"""Fused soft-to-hard quantizer: CUDA kernels 1 (forward) and 7 (backward),
their plain twins, and the autograd function that joins them.

Counterpart of imgcomp_cvpr_tpu/ops/pallas/quantize.py (``_forward`` and
``_vjp_bwd`` under ``jax.custom_vjp``). Each wrapper launches its kernel
(csrc/quantize.cu, csrc/quantize_bwd.cu) for a CUDA tensor and runs the
plain version only for a CPU tensor. The straight-through ``qbar``
arithmetic stays in models/quantizer.py, so qbar's cotangent reaches the
backward through qsoft.

The wrappers keep their host work small: the C functions are bound (with
their argument types) once, the current device is entered only when it is
not the tensor's, and besides its outputs kernel 7 uses one scratch buffer
and ticket counter per (device, stream), made on the first call there.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import build

_BWD_THREADS = 256          # csrc/quantize_bwd.cu: THREADS
_BWD_MAX_BLOCKS = 132 * 8   # 8 blocks for each of the H100's 132 SMs
_MAX_CENTERS = 32           # csrc/quantize*.cu: MAX_CENTERS
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_FWD_ARGTYPES = (_P, _LL, _P, _I, _F, _P, _P, _P, _P)
_BWD_ARGTYPES = (_P, _P, _P, _LL, _P, _I, _F, _P, _P, _P, _P, _I, _P)
_bwd_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def quantize_plain(x: torch.Tensor, centers: torch.Tensor, sigma: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(qsoft, qhard, symbols) with the Pallas kernel's order of operations
    (max over -sigma*d first, then the exp sums, then numer / denom;
    nearest center with a strict '<', so the first minimum wins)."""
    best_idx, max_neg = _argmin_and_max(x, centers, sigma)
    denom = torch.zeros_like(x)
    numer = torch.zeros_like(x)
    for l in range(centers.shape[0]):
        c = centers[l]
        e = torch.exp(-sigma * torch.square(x - c) - max_neg)
        denom = denom + e
        numer = numer + e * c
    return numer / denom, centers[best_idx.long()], best_idx


def _argmin_and_max(x, centers, sigma):
    best_dist = torch.full_like(x, float('inf'))
    best_idx = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    max_neg = torch.full_like(x, float('-inf'))
    for l in range(centers.shape[0]):
        d = torch.square(x - centers[l])
        take = d < best_dist
        best_dist = torch.where(take, d, best_dist)
        best_idx = torch.where(take, torch.full_like(best_idx, l), best_idx)
        max_neg = torch.maximum(max_neg, -sigma * d)
    return best_idx, max_neg


def quantize_bwd_plain(x: torch.Tensor, centers: torch.Tensor,
                       g: Optional[torch.Tensor], gh: Optional[torch.Tensor],
                       sigma: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dcenters) for cotangents g of qsoft and gh of qhard (None = 0),
    written out from the derivatives, not taken by autograd:
      d qsoft/dx   = sum_l p_l (-2 sigma (x - c_l)) (c_l - qsoft)
      d qsoft/dc_l = p_l (1 + 2 sigma (x - c_l)(c_l - qsoft))
      d qhard/dc_l = [argmin == l]
    with p = softmax(-sigma (x - c)^2) computed as in ``quantize_plain``."""
    g = torch.zeros_like(x) if g is None else g
    best_idx, max_neg = _argmin_and_max(x, centers, sigma)
    L = centers.shape[0]
    es = [torch.exp(-sigma * torch.square(x - centers[l]) - max_neg) for l in range(L)]
    denom = torch.zeros_like(x)
    numer = torch.zeros_like(x)
    for l in range(L):
        denom = denom + es[l]
        numer = numer + es[l] * centers[l]
    qsoft = numer / denom
    dx = torch.zeros_like(x)
    dcs = []
    for l in range(L):
        c = centers[l]
        p = es[l] / denom
        diff = x - c
        dx = dx + p * (-2.0 * sigma * diff) * (c - qsoft)
        per_elem = g * (p * (1.0 + 2.0 * sigma * diff * (c - qsoft)))
        if gh is not None:
            per_elem = per_elem + gh * (best_idx == l).to(x.dtype)
        dcs.append(per_elem.sum())
    return g * dx, torch.stack(dcs)


def _check(x: torch.Tensor, centers: torch.Tensor, what: str) -> None:
    if x.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError(f'{what} takes float32, got {x.dtype}/{centers.dtype}')
    if centers.ndim != 1 or not 1 <= centers.shape[0] <= 32:
        raise ValueError(f'centers must be (L,), 1 <= L <= 32: {tuple(centers.shape)}')
    if x.device.type not in ('cpu', 'cuda') or centers.device != x.device:
        raise ValueError(f'{what}: x on {x.device}, centers on {centers.device}')


def _empty_like_aligned(x: torch.Tensor, dtype: torch.dtype, off: int) -> torch.Tensor:
    """An empty 4-byte tensor of x's shape that starts ``off`` elements past a
    16-byte boundary, as x does (off = x.data_ptr() % 16 // 4), so that the
    kernels' 16-byte accesses line up (a fresh tensor starts 16-byte aligned;
    only a view into another tensor's storage may not)."""
    if not off:
        return torch.empty(x.shape, dtype=dtype, device=x.device)
    return torch.empty(x.numel() + off, dtype=dtype, device=x.device)[off:].view(x.shape)


def quantize_fwd(x: torch.Tensor, centers: torch.Tensor, sigma: float = 1.0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (...) f32, centers (L,) f32 -> (qsoft, qhard, symbols int32).
    No autograd graph on a CUDA tensor: differentiate through QuantizeFn."""
    _check(x, centers, 'quantize_fwd')
    if x.device.type == 'cpu':
        return quantize_plain(x, centers, sigma)
    xc = x.contiguous()
    cc = centers.contiguous()
    off = xc.data_ptr() % 16 // 4
    qsoft = _empty_like_aligned(xc, torch.float32, off)
    qhard = _empty_like_aligned(xc, torch.float32, off)
    sym = _empty_like_aligned(xc, torch.int32, off)
    fn = build.entry('quantize', 'quantize_fwd', _FWD_ARGTYPES)
    with build.on_device(xc.device):
        err = fn(xc.data_ptr(), xc.numel(), cc.data_ptr(), cc.shape[0], float(sigma),
                 qsoft.data_ptr(), qhard.data_ptr(), sym.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    build.LAUNCHES['quantize'] += 1
    build.check(err, 'quantize_fwd')
    return qsoft, qhard, sym


def bwd_blocks(n: int) -> int:
    """Grid of kernel 7, from n alone: the order of the dcenters sums, and
    so their bits, must not depend on anything else. A thread takes 4
    elements an iteration."""
    return max(1, min(-(-n // (4 * _BWD_THREADS)), _BWD_MAX_BLOCKS))


def _scratch(device: torch.device, stream: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 7's (blocks, L) partial sums and its ticket counter (0 between
    launches: the last block resets it) for one (device, stream)."""
    key = (device.index, stream)
    out = _bwd_scratch.get(key)
    if out is None:
        out = (torch.empty(_BWD_MAX_BLOCKS * _MAX_CENTERS, dtype=torch.float32, device=device),
               torch.zeros(1, dtype=torch.int32, device=device))
        _bwd_scratch[key] = out
    return out


def quantize_bwd(x: torch.Tensor, centers: torch.Tensor,
                 g: Optional[torch.Tensor], gh: Optional[torch.Tensor],
                 sigma: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (...) f32, centers (L,) f32, cotangents g of qsoft and gh of qhard
    (either may be None = 0) -> (dx like x, dcenters (L,))."""
    _check(x, centers, 'quantize_bwd')
    for name, t in (('g', g), ('gh', gh)):
        if t is not None and (t.dtype != torch.float32 or t.shape != x.shape
                              or t.device != x.device):
            raise ValueError(f'quantize_bwd: {name} is {t.dtype} {tuple(t.shape)} on '
                             f'{t.device}, x is float32 {tuple(x.shape)} on {x.device}')
    if x.device.type == 'cpu':
        return quantize_bwd_plain(x, centers, g, gh, sigma)
    xc = x.contiguous()
    cc = centers.contiguous()
    gc = None if g is None else g.contiguous()
    ghc = None if gh is None else gh.contiguous()
    L = cc.shape[0]
    dx = _empty_like_aligned(xc, torch.float32, xc.data_ptr() % 16 // 4)
    dcenters = torch.empty(L, dtype=torch.float32, device=xc.device)
    fn = build.entry('quantize_bwd', 'quantize_bwd', _BWD_ARGTYPES)
    with build.on_device(xc.device):
        stream = torch.cuda.current_stream().cuda_stream
        partial, counter = _scratch(xc.device, stream)
        err = fn(xc.data_ptr(), None if gc is None else gc.data_ptr(),
                 None if ghc is None else ghc.data_ptr(), xc.numel(), cc.data_ptr(), L,
                 float(sigma), dx.data_ptr(), dcenters.data_ptr(), partial.data_ptr(),
                 counter.data_ptr(), bwd_blocks(xc.numel()), stream)
    build.LAUNCHES['quantize_bwd'] += 1
    build.check(err, 'quantize_bwd')
    return dx, dcenters


class QuantizeFn(torch.autograd.Function):
    """(x, centers, sigma) -> (qsoft, qhard, symbols): kernel 1 forward and
    kernel 7 backward on CUDA tensors, the plain pair on CPU tensors."""

    @staticmethod
    def forward(ctx, x, centers, sigma):
        qsoft, qhard, symbols = quantize_fwd(x, centers, sigma)
        ctx.save_for_backward(x, centers)
        ctx.sigma = sigma
        ctx.mark_non_differentiable(symbols)
        ctx.set_materialize_grads(False)   # an unused output's cotangent stays None
        return qsoft, qhard, symbols

    @staticmethod
    def backward(ctx, g_qsoft, g_qhard, _g_symbols):
        x, centers = ctx.saved_tensors
        dx, dcenters = quantize_bwd(x, centers, g_qsoft, g_qhard, ctx.sigma)
        return dx, dcenters, None
