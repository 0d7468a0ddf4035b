"""Convolutions with TF-1.x 'SAME' semantics (port of
imgcomp_cvpr_tpu/ops/tf_compat.py).

- conv 'SAME', stride s: pad_total = max((ceil(H/s)-1)*s + k - H, 0),
  pad_lo = pad_total // 2 (the extra pad goes at the end);
- conv2d_transpose 'SAME' (output = input * stride) is the gradient of that
  conv: the full transposed convolution cropped by the forward conv's
  (pad_lo, pad_hi).

The public functions take NHWC activations and HWIO weights, like the JAX
package; the ``*_nchw`` variants take PyTorch's NCHW layout with the weight
already in F.conv2d's OIHW (or F.conv_transpose2d's IOHW) layout and are
what the model modules call.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def same_pad_amounts(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF 'SAME' (pad_lo, pad_hi) for one spatial dim."""
    out = -(-size // s)
    pad_total = max((out - 1) * s + k - size, 0)
    lo = pad_total // 2
    return lo, pad_total - lo


def conv2d_same_nchw(x: torch.Tensor, w_oihw: torch.Tensor, stride: int = 1
                     ) -> torch.Tensor:
    kh, kw = w_oihw.shape[2], w_oihw.shape[3]
    ph = same_pad_amounts(x.shape[2], kh, stride)
    pw = same_pad_amounts(x.shape[3], kw, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w_oihw, stride=stride)


def conv2d_transpose_same_nchw(x: torch.Tensor, w_iohw: torch.Tensor, stride: int
                               ) -> torch.Tensor:
    kh, kw = w_iohw.shape[2], w_iohw.shape[3]
    h_out, w_out = x.shape[2] * stride, x.shape[3] * stride
    ph_lo, _ = same_pad_amounts(h_out, kh, stride)
    pw_lo, _ = same_pad_amounts(w_out, kw, stride)
    y = F.conv_transpose2d(x, w_iohw, stride=stride)   # (H-1)s + k rows
    return y[:, :, ph_lo:ph_lo + h_out, pw_lo:pw_lo + w_out]


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """2D conv, NHWC x HWIO -> NHWC, TF-'SAME' padding."""
    y = conv2d_same_nchw(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride)
    return y.permute(0, 2, 3, 1)


def conv2d_transpose_same(x: torch.Tensor, w: torch.Tensor, stride: int
                          ) -> torch.Tensor:
    """tf.nn.conv2d_transpose(..., padding='SAME'), output = input * stride;
    ``w`` is (kh, kw, I=x channels, O=output channels)."""
    y = conv2d_transpose_same_nchw(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1),
                                   stride)
    return y.permute(0, 2, 3, 1)


def conv2d_valid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID 2D conv, NHWC x HWIO -> NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def depthwise_conv2d_valid_nchw(x: torch.Tensor, k2d: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID conv of (N, C, H, W) with one (kh, kw) kernel shared
    by every channel (the metric blurs' case), in full float32."""
    c = x.shape[1]
    return F.conv2d(x, k2d.to(x.dtype).expand(c, 1, *k2d.shape), groups=c)


def reflect_pad_hw_nchw(x: torch.Tensor, pad: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """REFLECT pad (no edge repeat) on H and W of an NCHW tensor."""
    (ph_lo, ph_hi), (pw_lo, pw_hi) = pad
    return F.pad(x, (pw_lo, pw_hi, ph_lo, ph_hi), mode='reflect')
