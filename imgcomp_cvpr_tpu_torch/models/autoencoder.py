"""Convolutional autoencoder with importance map (port of
imgcomp_cvpr_tpu/models/autoencoder.py, ref autoencoder.py:213-268).

Every forward takes an explicit ``train`` flag like the flax modules (the
nn.Module training mode is not consulted). BatchNorm is written out to
match flax's (eps 1e-5, (x - mean) * (scale * rsqrt(var + eps)) + bias):
with ``train`` it normalizes with the batch mean and the biased batch
variance E[x^2] - E[x]^2 (clipped at 0) and moves the running statistics
as ra = 0.9 ra + 0.1 batch with that same biased variance; without, it
uses the running statistics. The towers run NCHW internally (in eval mode
on the card, NCHW tensors in channels-last memory, which the public NHWC
inputs already are); the public methods take and return NHWC like the JAX
package. Module and parameter names mirror the flax tree so weights.py can
map a parameter tree one key to one tensor.

``dtype`` is the towers' compute dtype, as in the reference (its
autoencoder.py:65-80, 100, 135, 174); the parameters stay float32. Each conv
casts its input and weight to ``dtype``; BatchNorm upcasts the conv output
to float32, normalizes there and casts back (flax's ``_normalize`` computes
``x - mean`` and the scale in float32, because the float32 running
statistics promote it, then casts to ``dtype``); ReLU and the residual adds
run in ``dtype``. The bottleneck (heatmap, quantizer) and the decoder's
denormalize and clip run in float32. Training runs float32 only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device
from ..ops import tf_compat
from ..ops.kernels import ae_epilogue as epilogue_lib
from ..parallel import mesh as mesh_lib
from ..utils.spans import span
from . import quantizer as quantizer_lib

ARCH_PARAM_N = 128
SUBSAMPLING_FACTOR = 8

_NORM_MEAN = np.array([121.85369873, 113.58860779, 100.63715363], np.float32)
_NORM_VAR = np.array([4746.37695312, 4454.13964844, 4812.234375], np.float32)
_NORM_STD = np.sqrt(_NORM_VAR + 1e-10).astype(np.float32)


class EncoderOutput(NamedTuple):
    qbar: torch.Tensor               # (N, H', W', C) straight-through quantized
    qhard: torch.Tensor              # (N, H', W', C) nearest-center values
    symbols: torch.Tensor            # (N, H', W', C) int32 center indices
    z: torch.Tensor                  # (N, H', W', C) pre-quantization bottleneck
    heatmap: Optional[torch.Tensor]  # (N, H', W', C) in [0, 1], or None


class SlimConv(nn.Module):
    """conv (no bias) -> BatchNorm -> optional ReLU -> optional residual
    adds, TF-'SAME', NCHW.

    Without ``train`` the weight in ``dtype`` and the BatchNorm operands
    (running mean, mul = rsqrt(var + eps) * scale, bias) are folded once per
    parameter state (keyed on each tensor's storage and version counter, so
    load_state_dict, an optimizer step or a running-statistics update folds
    again), a symmetric pad goes to the conv instead of a padded copy, and
    the chain after the conv is ``ae_epilogue.epilogue``: on the card one
    kernel over channels-last activations, on the CPU the eager chain. With
    ``train`` (float32, autograd, batch statistics) it is the eager chain
    after the conv on a padded copy, NCHW."""

    BN_MOMENTUM = 0.9
    BN_EPS = 1e-5

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1,
                 act: bool = True, transpose: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.act, self.transpose = stride, act, transpose
        self.dtype = dtype
        shape = ((cin, features, kernel, kernel) if transpose
                 else (features, cin, kernel, kernel))
        self.weight = nn.Parameter(torch.zeros(shape))
        self.bn_scale = nn.Parameter(torch.ones(features))
        self.bn_bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('bn_mean', torch.zeros(features))
        self.register_buffer('bn_var', torch.ones(features))
        # (key, source tensors, (w, mean, mul, bias)); holding the sources keeps
        # their storage, and so a key, from being reused by other tensors
        self._folded = None

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.transpose:
            return tf_compat.conv2d_transpose_same_nchw(x, w, self.stride)
        return tf_compat.conv2d_same_nchw(x, w, self.stride)

    def _eval_conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``_conv``, with a symmetric TF-SAME pad (every stride-1 conv of odd
        k) given to the convolution as ``padding=`` instead of a padded copy."""
        if not self.transpose:
            ph = tf_compat.same_pad_amounts(x.shape[2], w.shape[2], self.stride)
            pw = tf_compat.same_pad_amounts(x.shape[3], w.shape[3], self.stride)
            if ph[0] == ph[1] and pw[0] == pw[1]:
                return F.conv2d(x, w, stride=self.stride, padding=(ph[0], pw[0]))
        return self._conv(x, w)

    def _eval_operands(self):
        """(w in dtype, mean, mul, bias): folded once per parameter state; with
        autograd on and parameters that need grad, built anew with their graph."""
        srcs = (self.weight, self.bn_scale, self.bn_bias, self.bn_mean, self.bn_var)
        if torch.is_grad_enabled() and self.weight.requires_grad:
            mul = torch.rsqrt(self.bn_var + self.BN_EPS) * self.bn_scale
            return self.weight.to(self.dtype), self.bn_mean, mul, self.bn_bias
        key = tuple((t.data_ptr(), t._version) for t in srcs)
        if self._folded is None or self._folded[0] != key:
            with torch.no_grad():
                w = self.weight.detach().to(self.dtype)
                if w.is_cuda:
                    w = w.contiguous(memory_format=torch.channels_last)
                mul = torch.rsqrt(self.bn_var + self.BN_EPS) * self.bn_scale
                ops = (w, self.bn_mean.detach(), mul.detach(), self.bn_bias.detach())
            self._folded = (key, srcs, ops)
        return self._folded[2]

    def forward(self, x: torch.Tensor, train: bool = False,
                residuals: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        """``residuals`` (at most two, in ``dtype``) are added in order after
        the ReLU, each rounded to ``dtype``."""
        dt = self.dtype
        if not train:
            w, mean, mul, bias = self._eval_operands()
            x = x.to(dt, memory_format=torch.channels_last) if x.is_cuda else x.to(dt)
            y = self._eval_conv(x, w)
            return epilogue_lib.epilogue(y, mean, mul, bias, self.act, residuals)
        if dt != torch.float32:
            raise ValueError(f'train mode runs float32 towers only, not {dt}')
        y = self._conv(x.to(dt), self.weight.to(dt)).float()
        # global-batch statistics under data parallelism (parallel/mesh.py)
        mean = mesh_lib.batch_mean(y, (0, 2, 3))
        var = torch.clamp(mesh_lib.batch_mean(torch.square(y), (0, 2, 3))
                          - torch.square(mean), min=0.0)
        with torch.no_grad():   # the running statistics, updated in place
            m = self.BN_MOMENTUM
            self.bn_mean.mul_(m).add_(mean, alpha=1 - m)
            self.bn_var.mul_(m).add_(var, alpha=1 - m)
        mul = torch.rsqrt(var + self.BN_EPS) * self.bn_scale
        return epilogue_lib.epilogue_plain(y, mean, mul, self.bn_bias, self.act, residuals)


class ResidualBlock(nn.Module):
    """Two 3x3 convs (BN after each, ReLU between) + identity skip;
    act=False drops the ReLU of both (ref autoencoder.py:274-287).
    ``skip``, when given, is the tower's group skip, added after the
    identity in the same epilogue."""

    def __init__(self, features: int, act: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = SlimConv(features, features, 3, act=act, dtype=dtype)
        self.conv2 = SlimConv(features, features, 3, act=False, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        residuals = (x,) if skip is None else (x, skip)
        return self.conv2(self.conv1(x, train), train, residuals)


class Encoder(nn.Module):
    def __init__(self, config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        n = ARCH_PARAM_N
        self.centers = nn.Parameter(torch.zeros(config.num_centers))
        self.h1 = SlimConv(3, n // 2, 5, stride=2, dtype=dtype)
        self.h2 = SlimConv(n // 2, n, 5, stride=2, dtype=dtype)
        for b in range(config.arch_param_B):
            for i in range(3):
                setattr(self, f'res_block_enc_{b}_{i + 1}', ResidualBlock(n, dtype=dtype))
        self.res_block_enc_final = ResidualBlock(n, act=False, dtype=dtype)
        num_out = config.num_chan_bn + (1 if config.heatmap else 0)
        self.to_bn = SlimConv(n, num_out, 5, stride=2, act=False, dtype=dtype)

    def forward(self, x_nhwc: torch.Tensor, train: bool = False) -> EncoderOutput:
        cfg = self.config
        net = normalize(x_nhwc, cfg.normalization).permute(0, 3, 1, 2)
        net = self.h2(self.h1(net, train), train)
        residual_input_0 = net
        for b in range(cfg.arch_param_B):
            residual_input_b = net
            for i in range(3):
                net = getattr(self, f'res_block_enc_{b}_{i + 1}')(
                    net, train, residual_input_b if i == 2 else None)
        net = self.res_block_enc_final(net, train, residual_input_0)
        net = self.to_bn(net, train).permute(0, 2, 3, 1).float()
        if cfg.heatmap:
            heatmap = get_heatmap3d(net)
            net = heatmap * net[..., 1:]
        else:
            heatmap = None
        q = quantizer_lib.quantize(net, self.centers, sigma=1.0)
        return EncoderOutput(q.qbar, q.qhard, q.symbols, net, heatmap)


class Decoder(nn.Module):
    def __init__(self, config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        n = ARCH_PARAM_N
        self.from_bn = SlimConv(config.num_chan_bn, n, 3, stride=2, transpose=True,
                                dtype=dtype)
        for b in range(config.arch_param_B):
            for i in range(3):
                setattr(self, f'res_block_dec_{b}_{i + 1}', ResidualBlock(n, dtype=dtype))
        self.dec_after_res = ResidualBlock(n, act=False, dtype=dtype)
        self.h12 = SlimConv(n, n // 2, 5, stride=2, transpose=True, dtype=dtype)
        self.h13 = SlimConv(n // 2, 3, 5, stride=2, act=False, transpose=True, dtype=dtype)

    def forward(self, q_nhwc: torch.Tensor, train: bool = False) -> torch.Tensor:
        cfg = self.config
        net = self.from_bn(q_nhwc.permute(0, 3, 1, 2), train)
        residual_input_0 = net
        for b in range(cfg.arch_param_B):
            residual_input_b = net
            for i in range(3):
                net = getattr(self, f'res_block_dec_{b}_{i + 1}')(
                    net, train, residual_input_b if i == 2 else None)
        net = self.dec_after_res(net, train, residual_input_0)
        net = self.h13(self.h12(net, train), train).permute(0, 2, 3, 1).float()
        return torch.clamp(denormalize(net, cfg.normalization), 0.0, 255.0)


class CVPRAutoencoder(nn.Module):
    """Top-level AE on NHWC tensors. ``forward(x, train)`` is the training
    entry (differentiable; decodes qbar when training, qhard otherwise);
    ``encode``/``decode`` are the codec path's entries: running statistics,
    no autograd graph. Its parameters live on ``device`` (raises for 'cuda'
    with no card) in float32; ``dtype`` is the towers' compute dtype
    (torch.bfloat16 for the serving path; training needs float32)."""

    def __init__(self, config, device='cuda', dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config, dtype)
        self.decoder = Decoder(config, dtype)
        self.to(resolve_device(device))

    def forward(self, x_nhwc: torch.Tensor, train: bool):
        enc = self.encoder(x_nhwc, train)
        x_out = self.decoder(enc.qbar if train else enc.qhard, train)
        return enc, x_out

    @torch.no_grad()
    def encode(self, x_nhwc: torch.Tensor) -> EncoderOutput:
        with span('ae.encode'):
            return self.encoder(x_nhwc, False)

    @torch.no_grad()
    def decode(self, q_nhwc: torch.Tensor) -> torch.Tensor:
        with span('ae.decode'):
            return self.decoder(q_nhwc, False)


def init_params(ae: CVPRAutoencoder, seed: int) -> CVPRAutoencoder:
    """Fresh weights for ``ae`` in place, from an explicit torch.Generator
    seeded with ``seed``: the flax initializers' distributions (glorot
    uniform over each conv's (k, k, cin, cout) kernel, fan_in = cin k k and
    fan_out = cout k k; BatchNorm scale 1, bias 0, mean 0, var 1; centers
    uniform in centers_initial_range). The numbers differ from jax.random's."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in ae.modules():
            if not isinstance(m, SlimConv):
                continue
            a, b, k, _ = m.weight.shape      # (cout, cin) or, transposed, (cin, cout)
            limit = float(np.sqrt(6.0 / ((a + b) * k * k)))
            w = (torch.rand(m.weight.shape, generator=g) * 2 - 1) * limit
            m.weight.copy_(w.to(m.weight.device))
            m.bn_scale.fill_(1.0)
            m.bn_bias.zero_()
            m.bn_mean.zero_()
            m.bn_var.fill_(1.0)
        cfg = ae.config
        centers = quantizer_lib.init_centers(g, cfg.num_centers, cfg.centers_initial_range)
        ae.encoder.centers.copy_(centers.to(ae.encoder.centers.device))
    return ae


def get_network_cls(config):
    return {'CVPR': CVPRAutoencoder}[config.arch]


@functools.lru_cache(maxsize=8)
def _norm_stats(device: torch.device, dtype: torch.dtype):
    """(mean, std) on ``device``, uploaded once: a blocking upload in every
    encode and decode would make the host wait for the card."""
    return (torch.from_numpy(_NORM_MEAN).to(device, dtype),
            torch.from_numpy(_NORM_STD).to(device, dtype))


def normalize(x: torch.Tensor, style: str) -> torch.Tensor:
    if style == 'OFF':
        return x
    if style == 'FIXED':
        mean, std = _norm_stats(x.device, x.dtype)
        return (x - mean) / std
    raise ValueError(f'Invalid normalization style {style}')


def denormalize(x: torch.Tensor, style: str) -> torch.Tensor:
    if style == 'OFF':
        return x
    if style == 'FIXED':
        mean, std = _norm_stats(x.device, x.dtype)
        return x * std + mean
    raise ValueError(f'Invalid normalization style {style}')


def get_heatmap3d(bottleneck: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C+1) -> (N, H, W, C) importance-map mask in [0, 1]."""
    c_dim = bottleneck.shape[-1] - 1
    heatmap2d = torch.sigmoid(bottleneck[..., 0]) * c_dim
    c = torch.arange(c_dim, dtype=bottleneck.dtype, device=bottleneck.device)
    return torch.clamp(heatmap2d[..., None] - c, 0.0, 1.0)
